"""CPU tests of the reference's scan of run-time instances
(rtbench/reference/iscan.py), of the instanced scene and of the check on
the instanced cell; of the frozen builder's batched scene bounds, and of
instanced hit ids past 32 bits through the capture and the check."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import registry
from rtbench.capture import Capture
from rtbench.scenedesc import Recorder, load_generator, replay
from rtbench.run import run_cell
from rtbench.reference.check import (make_scan, nearest_solid, T_TOL, _solid,
                                     closest_bad, prim_distance)
from rtbench.reference.iscan import InstScan
from rtbench.reference.scan import Scan, BIG
from rtbench.reference.snap.scene.builder import (SceneBuilder as RefBuilder,
                                                   _moves)
from rtbench.reference.snap.scene.intersect import _instance_triangles
from rtbench.reference.snap.scene.types import SHAPE_ITRI

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(resolution=(64, 36), n_tris=20000, foliage=40)
MIX = dict(lanes=1024, rows_per_tile=1, tiles_per_item=16, check_lanes=48,
           max_depth=6)
# SMALL's 40 shrubs are 1/60 of the cell's density, and its instanced
# answers a few percent of the closest answers; 400 shrubs (1/6 of the
# cell's density) make them a share in which a fault confined to them
# shows
DENSE = dict(SMALL, foliage=400)
SEED = 2 ** 31 + 77


def _descs(**params):
    """(instanced, flattened) descriptions of the same courtyard."""
    inst = load_generator(ROOT, "sanmiguel_instanced")(**params)
    flat = load_generator(ROOT, "sanmiguel_instanced")(**params)
    flat.calls = [(n, a, dict(k, runtime=False)
                   if n == "add_model_instance" else k)
                  for n, a, k in flat.calls]
    return inst, flat


def test_instanced_generator_matches_the_port(monkeypatch):
    """The generator is the port's sanmiguel_analog with its shrubs kept
    as run-time instances (PT_FLATTEN_MAX=0)."""
    from pathtracing_tpu_torch.scenes import sanmiguel_analog
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    desc = load_generator(ROOT, "sanmiguel_instanced")(**SMALL)
    monkeypatch.setenv("PT_FLATTEN_MAX", "0")
    s0, c0, m0 = sanmiguel_analog(device="cpu", **SMALL)
    monkeypatch.delenv("PT_FLATTEN_MAX")
    s1, c1, m1 = replay(desc, SceneBuilder()).build(**desc.build_kwargs,
                                                    device="cpu")
    assert m0 == m1 and set(s0) == set(s1)
    assert m1.n_inst == SMALL["foliage"] and m1.n_obj_tri == 96
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in c0:
        assert k == "resolution" or torch.equal(c0[k], c1[k]), k
    # the reference's own build keeps the same instances
    s2, _, m2 = replay(desc, RefBuilder()).build(accel="brute", device="cpu")
    assert m2.n_inst == m1.n_inst and m2.n_tri == m1.n_tri
    for k in ("otri_v", "otri_uv", "otri_prop", "inst_fwd", "inst_inv",
              "inst_base", "inst_count", "tri_v"):
        assert torch.equal(s1[k], s2[k]), k


def _first_any(scene, scan, o, d):
    """Per ray, the nearest surface it meets whether it stops the ray or
    not, and whether it does (BIG, False: none)."""
    n = o.shape[0]
    tmax = torch.full((n,), BIG)
    ray, tri, t, u, v = scan.tri_hits(o, d, tmax)
    solid = _solid(scene, scene["tri_prop"][tri], scene["tri_uv"][tri], u, v)
    if scan.inst is not None:
        r2, _, otri, t2, u2, v2 = scan.inst.hits(o, d, tmax)
        s2 = _solid(scene, scene["otri_prop"][otri], scene["otri_uv"][otri],
                    u2, v2)
        ray, t, solid = (torch.cat(x) for x in ((ray, r2), (t, t2),
                                                 (solid, s2)))
    best = torch.full((n,), BIG).scatter_reduce(0, ray, t, reduce="amin")
    first = (t == best[ray])
    verdict = torch.zeros(n, dtype=torch.bool)
    verdict[ray[first]] = solid[first]
    return best, verdict


def test_instanced_scan_matches_the_flattened_scene():
    """Rays into the shrubs: the instance-aware scan finds the nearest
    solid surface, and the solid / free verdict on the alpha cells, that
    the plain scan finds on the same shrubs flattened into world
    triangles."""
    inst, flat = _descs(**SMALL)
    si, _, mi = replay(inst, RefBuilder()).build(accel="brute", device="cpu")
    sf, _, mf = replay(flat, RefBuilder()).build(accel="brute", device="cpu")
    assert mi.n_inst == 40 and mf.n_inst == 0
    assert mf.n_tri == mi.n_tri + 40 * 96
    g = torch.Generator().manual_seed(5)
    centre = si["inst_fwd"][:, :, 3]                       # [I, 3]
    k = 24
    aim = centre.repeat_interleave(k, 0) \
        + (torch.rand((40 * k, 3), generator=g) - 0.5) * 2.0 \
        + torch.tensor([0.0, 0.8, 0.0])
    o = aim + torch.tensor([4.0, 9.0, -3.0]) \
        + torch.randn((40 * k, 3), generator=g)
    d = aim - o
    d = d / d.norm(dim=-1, keepdim=True)
    scan_i, scan_f = make_scan(si, mi), make_scan(sf, mf)
    assert scan_i.inst is not None and scan_f.inst is None
    far = torch.full((o.shape[0],), BIG)
    ti, tf = nearest_solid(si, scan_i, o, d, far), \
        nearest_solid(sf, scan_f, o, d, far)
    both = (ti < BIG) & (tf < BIG)
    assert torch.equal(ti < BIG, tf < BIG)
    assert bool(((ti - tf).abs()[both]
                 <= T_TOL * tf[both].clamp(min=1.0)).all())
    # the same first surface, and the same verdict on it
    bi, vi = _first_any(si, scan_i, o, d)
    bf, vf = _first_any(sf, scan_f, o, d)
    assert bool(((bi - bf).abs() <= T_TOL * bf.clamp(min=1.0)).all())
    assert torch.equal(vi, vf)
    # the rays meet alpha cells both ways: many stop on a leaf, many pass
    # a cut-out part and stop further on
    leaf = bi < ti - T_TOL * ti.clamp(min=1.0)
    assert int(leaf.sum()) > 50 and int((~leaf & (bi < BIG)).sum()) > 50


def _soup(n_inst, off_path, n_tri=200, seed=3):
    """A scene of instanced small random triangles: n_inst instances of one
    model along the x axis, and off_path more far off it."""
    g = torch.Generator().manual_seed(seed)
    v = (torch.rand((n_tri, 1, 3), generator=g) - 0.5) \
        + 0.1 * (torch.rand((n_tri, 3, 3), generator=g) - 0.5)
    fwd, inv = [], []
    for i in range(n_inst + off_path):
        s = 0.5 + 0.1 * (i % 7)
        t = torch.tensor([4.0 * i, 0.0, 0.0]) if i < n_inst \
            else torch.tensor([4.0 * (i - n_inst), 50.0 + 3.0 * (i % 5),
                               -40.0])
        m = torch.eye(4)
        m[:3, :3] *= s
        m[:3, 3] = t
        fwd.append(m[:3])
        inv.append(torch.linalg.inv(m)[:3])
    n = n_inst + off_path
    return dict(otri_v=v, inst_fwd=torch.stack(fwd), inst_inv=torch.stack(inv),
                inst_base=torch.zeros(n, dtype=torch.int32),
                inst_count=torch.full((n,), n_tri, dtype=torch.int32))


def test_scan_cost_follows_the_instances_a_ray_enters():
    """The same rays over 5 instances on their path, then with 10x more
    instances placed off it: the same hits, the same triangle tests."""
    g = torch.Generator().manual_seed(11)
    n = 64
    o = torch.stack([torch.full((n,), -3.0),
                     (torch.rand(n, generator=g) - 0.5) * 0.4,
                     (torch.rand(n, generator=g) - 0.5) * 0.4], 1)
    d = torch.tensor([1.0, 0.0, 0.0]) + 0.01 * torch.randn((n, 3),
                                                          generator=g)
    tmax = torch.full((n,), BIG)
    few, many = InstScan(_soup(5, 0)), InstScan(_soup(5, 50))
    hf, hm = few.hits(o, d, tmax), many.hits(o, d, tmax)
    assert few.tri_tests == many.tri_tests > 0
    for a, b in zip(hf, hm):
        assert torch.equal(a, b)
    # each ray enters the 5 instances' boxes and no other, and tests a
    # tenth or less of the 55 x 200 instanced triangles a flattened scan
    # would test
    ray, inst = many.pairs(o, d, tmax)
    assert bool((inst < 5).all()) and ray.numel() >= n
    assert many.tri_tests * 10 < n * 55 * 200
    # the hits are the brute-force hits of the instances flattened
    soup = _soup(5, 0)
    w = soup["otri_v"] @ soup["inst_fwd"][:, None, :, :3].transpose(-1, -2) \
        + soup["inst_fwd"][:, None, None, :, 3]
    for r in range(0, n, 7):
        t, ok, _, _ = Scan.tri_hit(o[r], d[r], w.reshape(-1, 3, 3))
        want = torch.sort(t[ok]).values
        got = torch.sort(hm[3][hm[0] == r]).values
        assert got.shape == want.shape
        assert torch.allclose(got, want, rtol=1e-4)
        # the hit's id names the instance and the object triangle
        idx = torch.nonzero(ok)[:, 0]
        assert torch.equal(torch.sort(idx).values, torch.sort(
            hm[1][hm[0] == r] * 200 + hm[2][hm[0] == r]).values)


def _run(params=SMALL, **kw):
    return run_cell("instanced-fwd-d32", SEED, 0.5, device="cpu",
                    params=params, traffic_over=MIX, **kw)


def test_lower_precision_control_fails_on_instances():
    r = _run(control="bf16")
    assert not r["correct"], r["checks"]
    assert r["info"]["instanced_hits_checked"] > 0


@pytest.mark.parametrize("fault", ["instance_off_by_one",
                                   "object_triangle_off_by_one"])
def test_broken_instanced_answers_are_incorrect(monkeypatch, fault):
    """The program's instanced closest-hit answers name the next instance
    (or the next triangle of the model): the check reads correct false."""
    from pathtracing_tpu_torch.integrators import path
    orig = path._intersect

    def intersect(scene, meta, *a, **k):
        hit = orig(scene, meta, *a, **k)
        n = meta.n_inst * meta.n_obj_tri
        step = meta.n_obj_tri if fault == "instance_off_by_one" else 1
        bad = (hit["kind"] == 3) & hit["valid"]
        return dict(hit, idx=torch.where(bad, (hit["idx"] + step) % n,
                                         hit["idx"]))
    sound = _run(params=DENSE)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(path, "_intersect", intersect)
    r = _run(params=DENSE)
    assert not r["correct"], r["checks"]
    assert r["checks"]["closest_bad_share"]["value"] > 0.2


def _moving_models():
    """Three models of a few triangles, 60 instances turned, scaled
    unevenly and moved, a third of them moving over the shutter."""
    rng = np.random.default_rng(4)
    desc = Recorder()
    mat = desc.add_diffuse()
    desc.add_mesh(rng.random((30, 3)) * 5, np.arange(30).reshape(-1, 3),
                  material=mat)
    models = [desc.add_model(rng.normal(size=(3 * n, 3)),
                             np.arange(3 * n).reshape(-1, 3), material=mat)
              for n in (7, 40, 3)]
    for k in range(60):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        tf = np.eye(4)
        tf[:3, :3] = q * rng.uniform(0.3, 3.0, 3)
        tf[:3, 3] = rng.normal(size=3) * 50
        desc.add_model_instance(models[k % 3], transform=tf, runtime=True,
                                velocity=rng.normal(size=3) if k % 3 == 1
                                else (0.0, 0.0, 0.0))
    desc.set_camera((0, 0, -10), (0, 0, 0), 0.8, (32, 18),
                    shutter=(0.0, 1.0))
    return desc


def bounds_one_by_one(b):
    """The frozen builder's scene bounds as it took them before they were
    batched, the oracle of the batched ones: every instance's model
    triangles read again, its box's corners through its transform one
    instance at a time."""
    pts = []
    if b._tri["v"]:
        pts.append(np.asarray(b._tri["v"]).reshape(-1, 3))
    if b._sph["r"]:
        c = np.asarray(b._sph["c"])
        r = np.asarray(b._sph["r"])[:, None]
        pts += [c - r, c + r]
    if b._quad["q"]:
        q = np.asarray(b._quad["q"])
        u = np.asarray(b._quad["u"])
        v = np.asarray(b._quad["v"])
        pts += [q, q + u, q + v, q + u + v]
    for inst in b._inst:
        ov = np.asarray(b._obj["v"][inst["base"]:
                                    inst["base"] + inst["count"]])
        if len(ov):
            lo_o = ov.reshape(-1, 3).min(0)
            hi_o = ov.reshape(-1, 3).max(0)
            corners = np.array([[x, y, z] for x in (lo_o[0], hi_o[0])
                                for y in (lo_o[1], hi_o[1])
                                for z in (lo_o[2], hi_o[2])])
            wc = corners @ inst["fwd"][:, :3].T + inst["fwd"][:, 3]
            pts += [wc]
            if _moves(inst["vel"]):        # union over the shutter
                sh = (b.camera or {}).get("shutter", (0.0, 0.0))
                pts += [wc + inst["vel"] * sh[0], wc + inst["vel"] * sh[1]]
    if not pts:
        return np.zeros(3), np.ones(3)
    allp = np.concatenate(pts, 0)
    return allp.min(0), allp.max(0)


@pytest.mark.parametrize("config", ["sanmiguel-faithful", "sanmiguel-legacy",
                                    "sanmiguel-instanced", "moving-models"])
def test_scene_bounds_are_the_one_by_one_bounds(config):
    """The frozen builder takes each model's box once and pushes every
    instance's box corners through its transform in one batched product:
    the bounds are bit for bit those of one instance at a time, on the
    configurations' descriptions (their terrain cut to 20,000 triangles;
    their shrubs all there) and on moving, unevenly scaled instances of
    three models."""
    if config == "moving-models":
        desc = _moving_models()
    else:
        conf = registry.config(config)
        desc = load_generator(ROOT, conf["generator"])(
            **dict(conf["params"], resolution=(64, 36), n_tris=20000))
    b = replay(desc, RefBuilder())
    b._maybe_flatten_instances()
    n_inst = {"sanmiguel-instanced": 2500, "moving-models": 60}
    assert len(b._inst) == n_inst.get(config, 0)
    lo, hi = b._scene_bounds()
    lo0, hi0 = bounds_one_by_one(b)
    assert lo.dtype == lo0.dtype and hi.dtype == hi0.dtype
    assert np.array_equal(lo, lo0) and np.array_equal(hi, hi0)


def _wide_ids():
    """A scene whose instanced hit ids pass 2^31: a 65,520-triangle model
    instanced once far off, a 16-triangle patch instanced 33,000 times (the
    last 10 on the rays' path, the rest far off) and a one-triangle
    emitter instanced last: 33,002 instances x 65,537 object triangles,
    over one world triangle off the path."""
    desc = Recorder()
    mat = desc.add_diffuse()
    desc.add_mesh(np.array([[0, -50, 0], [1, -50, 0], [0, -50, 1.0]]),
                  np.array([[0, 1, 2]]), material=mat)
    rng = np.random.default_rng(6)
    big = desc.add_model(rng.random((3 * 65520, 3)) * 0.01,
                         np.arange(3 * 65520).reshape(-1, 3), material=mat)
    g = np.linspace(-0.5, 0.5, 3)
    quads = [((g[i], g[j]), (g[i + 1], g[j + 1])) for i in range(2)
             for j in range(2)]
    verts = []
    for (x0, y0), (x1, y1) in quads:       # 4 quads of 4 triangles each
        xm, ym = (x0 + x1) / 2, (y0 + y1) / 2
        c = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        for a in range(4):
            verts += [c[a], c[(a + 1) % 4], (xm, ym)]
    patch = np.array([(x, y, 0.0) for x, y in verts])
    small = desc.add_model(patch, np.arange(48).reshape(-1, 3), material=mat)
    lamp = desc.add_model(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                          np.array([[0, 1, 2]]), emission=(40.0, 40.0, 40.0))

    def at(x, y, z):
        tf = np.eye(4)
        tf[:3, 3] = (x, y, z)
        return tf
    desc.add_model_instance(big, transform=at(1e3, 1e3, 1e3), runtime=True)
    for k in range(33000):
        on_path = k >= 32990
        desc.add_model_instance(
            small, transform=at(3.0 * (k - 32990), 0, 5 + k % 3) if on_path
            else at(-500.0 - 2 * (k % 200), 300.0 + 2 * (k // 200), 0),
            runtime=True)
    desc.add_model_instance(lamp, transform=at(0, 40, 0), runtime=True)
    desc.set_camera((0, 0, -10), (0, 0, 0), 0.8, (32, 18))
    return desc


def test_instanced_ids_past_32_bits_are_judged():
    """An instanced answer whose id (instance x n_obj_tri + object
    triangle) passes 2^31: the capture keeps it whole, the check judges it
    good when it names the hit and bad when it names a neighbouring
    triangle or instance; the frozen bounce decodes it; the emitter's
    light names its id."""
    scene, _, meta = replay(_wide_ids(), RefBuilder()).build(accel="brute",
                                                             device="cpu")
    assert meta.n_inst == 33002 and meta.n_obj_tri == 65537
    assert meta.n_inst * meta.n_obj_tri > 2 ** 31 - 1
    lamp = scene["light_shape"][scene["light_shape"][:, 0] == SHAPE_ITRI]
    assert lamp.tolist() == [[SHAPE_ITRI, 33001 * 65537 + 65536]]
    scan = make_scan(scene, meta)
    gen = torch.Generator().manual_seed(3)
    n = 64
    target = torch.randint(32990, 33000, (n,), generator=gen)
    o = torch.stack([3.0 * (target - 32990).float(), torch.zeros(n),
                     torch.full((n,), -1.0)], 1) \
        + torch.cat([(torch.rand((n, 2), generator=gen) - 0.5) * 0.6,
                     torch.zeros((n, 1))], 1)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, 1.0]) + 0.005 * torch.randn((n, 3),
                                                            generator=gen),
        dim=-1)
    ray, inst, otri, t, _, _ = scan.inst.hits(o, d, torch.full((n,), BIG))
    near = torch.full((n,), BIG).scatter_reduce(0, ray, t, reduce="amin")
    first = t == near[ray]
    assert torch.equal(torch.sort(ray[first]).values, torch.arange(n))
    order = torch.argsort(ray[first])
    hit_t = t[first][order]
    idx = (inst * meta.n_obj_tri + otri)[first][order]
    assert idx.dtype == torch.int64 and bool((idx > 2 ** 31).all())
    # what the program hands the capture, and what the check reads of it
    cap = Capture(torch.arange(n), 4)

    def intersect(scene_, meta_, origin, direction, t_max, time=None):
        return dict(t=hit_t, kind=torch.full((n,), SHAPE_ITRI), idx=idx,
                    valid=torch.ones(n, dtype=torch.bool))
    cap._cur = {}
    cap._wrap_intersect(intersect)(scene, meta, o, d, BIG)
    cap.records.append(dict(item=0, **cap._cur))
    g = cap.gathered()
    assert g["hit_idx"].dtype == torch.int64
    assert torch.equal(g["hit_idx"], idx)

    def bad(ids):
        return closest_bad(scene, scan, g["ray_o"], g["ray_d"], g["hit_t"],
                           g["hit_kind"], ids, g["hit_valid"])
    assert not bool(bad(g["hit_idx"]).any())
    assert bool(bad(g["hit_idx"] + 1).all())
    assert bool(bad(g["hit_idx"] + meta.n_obj_tri).all())
    t_named = prim_distance(scan, scene, o, d, g["hit_kind"], g["hit_idx"])
    assert torch.equal(t_named, hit_t)
    # the frozen bounce finds the same instance and object triangle
    _, iid, oid = _instance_triangles(scene, meta, idx)
    assert torch.equal(iid, idx // 65537) and torch.equal(oid, idx % 65537)
    assert bool((iid >= 32990).all()) and bool((oid >= 65520).all())
