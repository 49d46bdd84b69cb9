"""A production-scale field of opaque run-time instances, a synthetic
stress field of the Moana Island Scene's class (10^5 instances of models
of 10^3-10^6 triangles over a world of millions), built through the
port's instanced two-level tables and measured on the card by the
harness's K1 roofline probe and the reference's check.

    python3 rtbench/tools/inst_field.py --out chiprun_out/inst_field.json

The field (`field`), of fixed sizes: a terrain of ~4M world triangles over
1,000 x 1,000 units, and per group of MODELS (triangles x instances x
models) models of small opaque triangles in an ellipsoid, each instance
set on the terrain, turned about the vertical, tilted, scaled and moved.
Its counts are the stress field's, not a published scene's.  The tables
are built with the port's defaults, G = 32 child blocks per L1
(PT_BLOCK_G), and K1 runs with pops 4 (PT_POPS).  The rays: LANES camera
rays, every 32nd row of a 1920x1080 pinhole view over the field, and one
cosine bounce from each hit.

It prints, and writes to --out as one JSON object:
- `build`: the port's `build_tri_blocks2_inst` (its seconds, `k2` = the
  leaf size in triangles, G, the physical and expanded L1s, the slots);
- `probe`: `rtbench/roofline.py`'s K1Probe over the camera and bounce
  dispatches (share, bound, time per dispatch, flops, bytes), the
  probe's own seconds and the count's alone;
- `reference`: the description replayed into the reference's frozen
  builder (`reference/snap/`), its `_scene_bounds` timed alone, its
  build, the scan's set-up, and one check iteration's closest and shadow
  judgements of CHECK_LANES lanes (`reference/check.py` over `iscan.py`)
  with K1's own answers;
- `best_vs_reference`: the probe walk's nearest hits against the
  reference scan's on those lanes;
- `memory_peak_bytes` on the card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench.scenedesc import Recorder, replay  # noqa: E402

EXTENT = 1000.0
# per model group: the instances' scale range, the ellipsoid's height
# (object units) and a name
GROUPS = ((12.0, 20.0, 1.0, "canopy"), (1.5, 3.0, 0.8, "bush"),
          (0.3, 0.8, 0.35, "cover"))
SUN = (0.4, 0.8, 0.3)
G, POPS = 32, 4
WORLD_TRIS = 4_000_000
# (triangles, instances, models) per group: ~104,000 instances in all
MODELS = ((500_000, 40, 4), (20_000, 1_000, 8), (1_000, 12_000, 8))
LANES, CHECK_LANES = 65_280, 64
SEED = 2_147_483_911


def height(x, z):
    return 8.0 * np.sin(x / 80.0) * np.cos(z / 60.0) \
        + 3.0 * np.sin(x / 23.0 + z / 31.0)


def terrain(n_tris):
    """A height field of about n_tris triangles over the field: (vertices,
    indices)."""
    n = max(1, int(math.sqrt(n_tris / 2)))
    x, z = np.meshgrid(np.linspace(0, EXTENT, n + 1),
                       np.linspace(0, EXTENT, n + 1), indexing="ij")
    v = np.stack([x, height(x, z), z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None]
    a, b, c, d = i, i + 1, i + n + 1, i + n + 2
    idx = np.stack([np.stack([a, c, b], -1), np.stack([b, c, d], -1)],
                   2).reshape(-1, 3)
    return v, idx.astype(np.int32)


def model(n_tris, tall, rng):
    """A soup of n_tris small triangles in an ellipsoid standing on y = 0,
    dense enough to be opaque: (vertices, indices)."""
    c = rng.normal(size=(n_tris, 3))
    c /= np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-9)
    c *= rng.random((n_tris, 1)) ** (1 / 3)
    c *= np.array([1.0, tall, 1.0]) * rng.uniform(0.8, 1.2, 3)
    c[:, 1] += tall
    edge = 2.5 * (4.2 * tall / n_tris) ** (1 / 3)
    v = c[:, None] + edge * (rng.random((n_tris, 3, 3)) - 0.5)
    return (v.reshape(-1, 3).astype(np.float32),
            np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3))


def field(world_tris, groups, seed):
    """The field's description (a Recorder: what the reference's builder
    replays) and the raw arrays the port's table build takes, in the same
    order: world triangles, object triangles in first-instancing order,
    each instance's maps and range."""
    rng = np.random.default_rng(seed)
    desc = Recorder()
    mat = desc.add_diffuse(base_color=(0.5, 0.45, 0.35))
    tv, ti = terrain(world_tris)
    desc.add_mesh(tv, ti, material=mat)
    raw = dict(tri_v=tv[ti], otri_v=[], fwd=[], inv=[], base=[], count=[])
    first = 0
    for (n_tri, n_inst, n_models), (s0, s1, tall, _) in zip(groups, GROUPS):
        for _ in range(n_models):
            mv, mi = model(n_tri, tall, rng)
            mid = desc.add_model(mv, mi, material=mat)
            raw["otri_v"].append(mv[mi])
            pos = rng.random((n_inst, 2)) * EXTENT
            turn = rng.random(n_inst) * 2 * math.pi
            tilt = (rng.random((n_inst, 2)) - 0.5) * 0.35
            scale = rng.uniform(s0, s1, n_inst)
            stretch = rng.uniform(0.8, 1.25, n_inst)
            for k in range(n_inst):
                tf = np.eye(4)
                cy, sy = math.cos(turn[k]), math.sin(turn[k])
                cx, sx = math.cos(tilt[k, 0]), math.sin(tilt[k, 0])
                cz, sz = math.cos(tilt[k, 1]), math.sin(tilt[k, 1])
                ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
                rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
                tf[:3, :3] = rz @ rx @ ry * scale[k] \
                    * np.array([1.0, stretch[k], 1.0])
                x, z = pos[k]
                tf[:3, 3] = (x, height(x, z) - 0.1 * scale[k], z)
                tf = tf.astype(np.float32)
                desc.add_model_instance(mid, transform=tf, runtime=True)
                raw["fwd"].append(tf[:3, :4])
                raw["inv"].append(np.linalg.inv(tf)[:3, :4])
                raw["base"].append(first)
                raw["count"].append(n_tri)
            first += n_tri
    raw["otri_v"] = np.concatenate(raw["otri_v"])
    desc.add_distant_light(SUN, (3.0, 2.9, 2.7))
    desc.add_uniform_inf_light((0.4, 0.5, 0.7))
    desc.set_camera(*view(), resolution=(1920, 1080))
    return desc, raw


def view():
    """(look_from, look_at, vertical fov in radians) over the field."""
    return ((-60.0, 140.0, -60.0), (520.0, 0.0, 520.0), math.radians(50.0))


def camera_rays(lanes, device):
    """Whole rows of the 1920x1080 pinhole view, evenly spread: every
    32nd row for 65,280 lanes."""
    w, h = 1920, 1080
    eye, at, fov = view()
    eye, at = np.asarray(eye), np.asarray(at)
    fwd = (at - eye) / np.linalg.norm(at - eye)
    right = np.cross(fwd, (0.0, 1.0, 0.0))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    k = max(1, lanes // w)
    rows = ((np.arange(k) + 0.5) * h / k).astype(np.int64)
    py, px = np.meshgrid(rows, np.arange(w), indexing="ij")
    th = math.tan(fov / 2)
    sx = (2 * (px.ravel() + 0.5) / w - 1) * th * w / h
    sy = (1 - 2 * (py.ravel() + 0.5) / h) * th
    d = fwd + sx[:, None] * right + sy[:, None] * up
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(eye, (d.shape[0], 1))
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


def hit_normals(raw_t, hit, d):
    """Each hit's geometric normal, facing the ray, and a point on it."""
    tri = hit["tri"].clamp(min=0)
    inst = hit["inst"]
    world = raw_t["tri_v"][tri.clamp(max=raw_t["tri_v"].shape[0] - 1)]
    obj = raw_t["otri_v"][tri.clamp(max=raw_t["otri_v"].shape[0] - 1)]
    f = raw_t["fwd"][inst.clamp(min=0)]
    obj = obj @ f[:, :, :3].transpose(1, 2) + f[:, None, :, 3]
    v = torch.where((inst >= 0)[:, None, None], obj, world)
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = torch.nn.functional.normalize(n, dim=-1)
    return torch.where(((n * d).sum(-1) > 0)[:, None], -n, n)


def bounce_rays(raw_t, o, d, hit, gen):
    """A cosine-weighted bounce from every camera hit (dead lanes: t_max
    0 where the camera ray left the field)."""
    n = hit_normals(raw_t, hit, d)
    p = o + hit["t"].clamp(max=1e6)[:, None] * d
    u1 = torch.rand(n.shape[0], generator=gen, device=n.device)
    u2 = torch.rand(n.shape[0], generator=gen, device=n.device)
    r, phi = torch.sqrt(u1), 2 * math.pi * u2
    a = torch.where((n[:, 0].abs() > 0.9)[:, None],
                    n.new_tensor([0.0, 1.0, 0.0]), n.new_tensor([1.0, 0, 0]))
    t1 = torch.nn.functional.normalize(torch.linalg.cross(a, n), dim=-1)
    t2 = torch.linalg.cross(n, t1)
    dd = (r * torch.cos(phi))[:, None] * t1 + (r * torch.sin(phi))[:, None] \
        * t2 + torch.sqrt((1 - u1).clamp(min=0))[:, None] * n
    oo = p + 1e-3 * n
    t_max = torch.where(hit["valid"], torch.full_like(hit["t"], 3.0e38),
                        torch.zeros_like(hit["t"]))
    return oo, torch.nn.functional.normalize(dd, dim=-1), t_max, p, n


def run():
    from pathtracing_tpu_torch.accel import trace2
    from rtbench.roofline import K1Probe, k1_work, walk
    from rtbench.reference.check import (build_reference, make_scan,
                                         closest_bad, shadow_bad,
                                         nearest_solid, T_TOL)
    from rtbench.reference.scan import BIG
    from rtbench.reference.snap.scene.builder import SceneBuilder as RefB
    from rtbench.reference.snap.scene.types import SHAPE_TRI, SHAPE_ITRI

    dev = torch.device("cuda")
    res = dict(device=torch.cuda.get_device_name(0), seed=SEED,
               world_tris_asked=WORLD_TRIS,
               groups=[dict(model_tris=a, instances_each=b, models=c)
                       for a, b, c in MODELS])
    t = time.perf_counter()
    desc, raw = field(WORLD_TRIS, MODELS, SEED)
    res["describe_s"] = time.perf_counter() - t
    n_inst = len(raw["fwd"])
    res.update(world_tris=int(raw["tri_v"].shape[0]), instances=n_inst,
               object_tris=int(raw["otri_v"].shape[0]),
               instanced_tris=int(np.sum(raw["count"])))

    # ---- the port's tables
    t = time.perf_counter()
    arrays, k2 = trace2.build_tri_blocks2_inst(
        raw["tri_v"], raw["otri_v"], raw["fwd"], raw["inv"], raw["base"],
        raw["count"], g=G)
    build_s = time.perf_counter() - t
    scene = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
    torch.cuda.synchronize()
    m2, m1p = arrays["pk_l2box"].shape[0], arrays["pk_l1_base"].shape[0]
    res["build"] = dict(seconds=build_s, k2=int(k2), leaf_tris=int(k2),
                        g=int(m2 // m1p), physical_l1=int(m1p),
                        expanded_l1=int(arrays["pk_l1box"].shape[0]),
                        child_blocks=int(m2),
                        slots=int(arrays["pk_tri"].shape[0]),
                        table_bytes=int(sum(v.nbytes
                                            for v in arrays.values())))
    del arrays
    print(json.dumps(dict(build=res["build"])), flush=True)
    raw_t = dict(tri_v=torch.as_tensor(raw["tri_v"], device=dev),
                 otri_v=torch.as_tensor(raw["otri_v"], device=dev),
                 fwd=torch.as_tensor(np.stack(raw["fwd"]), device=dev))

    # ---- K1 on camera rays and their bounces, under the probe
    o, d = camera_rays(LANES, dev)
    n = o.shape[0]
    big = torch.full((n,), 3.0e38, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    probe = K1Probe(scene["pk_tri"]).install()
    probe.armed = True
    try:
        hit0 = trace2.tri_intersect2(scene, o, d, big, pops=POPS)
        o1, d1, t1, p, nrm = bounce_rays(raw_t, o, d, hit0, gen)
        trace2.tri_intersect2(scene, o1, d1, t1, pops=POPS)
    finally:
        probe.remove()
    torch.cuda.synchronize()
    calls = list(probe.calls)
    res["camera_hits"] = int(hit0["valid"].sum())
    res["camera_instanced_hits"] = int((hit0["inst"] >= 0).sum())
    t = time.perf_counter()
    k1 = probe.measure()
    probe_s = time.perf_counter() - t
    t = time.perf_counter()
    counts = [k1_work(sc, oo, dd, tm) for sc, oo, dd, tm, _ in calls]
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t
    res["probe"] = dict(k1, seconds=probe_s, count_s=count_s,
                        dispatches=len(calls),
                        flops_each=[c[0] for c in counts],
                        bytes_each=[c[1] for c in counts])
    res["probe"]["time_ms_per_dispatch"] = k1["time_ms"] / len(calls)
    print(json.dumps(dict(probe=res["probe"])), flush=True)

    # ---- the reference: replay, bounds, build, scan, one check iteration
    ref = {}
    t = time.perf_counter()
    b = replay(desc, RefB())
    ref["replay_s"] = time.perf_counter() - t
    b._maybe_flatten_instances()
    t = time.perf_counter()
    b._scene_bounds()
    ref["scene_bounds_s"] = time.perf_counter() - t
    del b
    t = time.perf_counter()
    rs, _, meta = build_reference(desc, dev)
    torch.cuda.synchronize()
    ref["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scan = make_scan(rs, meta)
    torch.cuda.synchronize()
    ref["scan_setup_s"] = time.perf_counter() - t
    ref["n_obj_tri"] = int(meta.n_obj_tri)
    lanes = torch.randperm(n, generator=torch.Generator().manual_seed(
        SEED))[:CHECK_LANES].to(dev)
    inst = hit0["inst"][lanes]
    kind = torch.where(inst >= 0, SHAPE_ITRI, SHAPE_TRI)
    idx = torch.where(inst >= 0, inst * meta.n_obj_tri + hit0["tri"][lanes],
                      hit0["tri"][lanes])
    ref["largest_hit_id"] = int(idx.max())
    t = time.perf_counter()
    cb = closest_bad(rs, scan, o[lanes], d[lanes], hit0["t"][lanes], kind,
                     idx, hit0["valid"][lanes])
    torch.cuda.synchronize()
    ref["closest_s"] = time.perf_counter() - t
    ref["closest_bad_share"] = float(cb.float().mean())
    sun = torch.nn.functional.normalize(torch.tensor(SUN, device=dev),
                                        dim=0)
    so = p[lanes] + 1e-3 * nrm[lanes]
    sd = sun.expand(so.shape[0], 3).contiguous()
    st = torch.where(hit0["valid"][lanes], 3.0e38, 0.0)
    occ = trace2.tri_intersect2(scene, so, sd, st, any_hit=True,
                                pops=POPS)["valid"]
    live = st > 0
    t = time.perf_counter()
    sb = shadow_bad(rs, scan, so[live], sd[live], st[live], occ[live])
    torch.cuda.synchronize()
    ref["shadow_s"] = time.perf_counter() - t
    ref["shadow_bad_share"] = float(sb.float().mean()) if sb.numel() else 0.0
    ref["shadow_lanes"] = int(live.sum())
    res["reference"] = ref
    # the probe walk's nearest hits against the reference's scan
    w = walk(scene, o[lanes], d[lanes], big[lanes])
    near = nearest_solid(rs, scan, o[lanes], d[lanes], big[lanes])
    hit = near < BIG
    gap = ((w["best"] - near).abs() / near.clamp(min=1.0))[hit]
    res["best_vs_reference"] = dict(
        lanes=int(lanes.numel()), hits=int(hit.sum()),
        same_hit_or_miss=bool(torch.equal(w["best"] < BIG, hit)),
        max_rel_gap=float(gap.max()) if gap.numel() else 0.0,
        limit=T_TOL)
    res["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("inst_field: needs a CUDA card", file=sys.stderr)
        return 2
    res = run()
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
