"""The frozen count of K1's work against a hand count, and its nearest
hits against the port's plain two-level walk; on tables with run-time
instances, the count by the instances against a hand count, its nearest
hits against the reference's scans, and its independence of the top
level's layout."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from rtbench.roofline import (k1_work, walk, bound_s, FP32_PEAK, HBM_RATE,
                              INST_TABLES)
from rtbench.reference.iscan import InstScan
from rtbench.reference.scan import Scan, BIG
from rtbench.reference.check import T_TOL


def _box(lo, hi):
    return list(lo) + [0.0] + list(hi) + [0.0]


def _tri(v0, v1, v2):
    v0, v1, v2 = (torch.tensor(v, dtype=torch.float32) for v in (v0, v1, v2))
    return torch.cat([v0, v1 - v0, v2 - v0, torch.zeros(3)]).tolist()


def test_count_by_hand():
    # three L1s of two child blocks of two triangles, in two coarse unions
    # (L1s 0 and 1; L1 2); the ray goes up +z from the origin and hits
    # triangle 0 at t = 1
    l1 = [_box((-1, -1, 0.5), (1, 1, 4)), _box((-1, -1, 5), (1, 1, 6)),
          _box((49, 49, 0.5), (51, 51, 4))]
    l2 = [_box((-1, -1, 0.5), (1, 1, 1.5)), _box((-1, -1, 3), (1, 1, 4)),
          _box((-1, -1, 5), (1, 1, 5.5)), _box((-1, -1, 5.5), (1, 1, 6)),
          _box((49, 49, 0.5), (51, 51, 1.5)), _box((49, 49, 3), (51, 51, 4))]
    tris = [_tri((-1, -1, 1), (1, -1, 1), (0, 1, 1)),
            _tri((5, 5, 1), (6, 5, 1), (5, 6, 1)),
            _tri((-1, -1, 3.5), (1, -1, 3.5), (0, 1, 3.5)),
            _tri((5, 5, 3), (6, 5, 3), (5, 6, 3)),
            _tri((-1, -1, 5.2), (1, -1, 5.2), (0, 1, 5.2)),
            _tri((5, 5, 5), (6, 5, 5), (5, 6, 5)),
            _tri((-1, -1, 5.7), (1, -1, 5.7), (0, 1, 5.7)),
            _tri((5, 5, 6), (6, 5, 6), (5, 6, 6)),
            _tri((49, 49, 1), (51, 49, 1), (50, 51, 1)),
            _tri((49, 49, 1.2), (51, 49, 1.2), (50, 51, 1.2)),
            _tri((49, 49, 3.5), (51, 49, 3.5), (50, 51, 3.5)),
            _tri((49, 49, 3.7), (51, 49, 3.7), (50, 51, 3.7))]
    unions = [_box((-1, -1, 0.5), (1, 1, 6)), _box((49, 49, 0.5), (51, 51, 4))]
    members = [[0, 1] + [-1] * 6, [2] + [-1] * 7]
    tables = dict(pk_cbox=torch.tensor(unions),
                  pk_cmem=torch.tensor(members, dtype=torch.int32),
                  pk_l1box=torch.tensor(l1), pk_l2box=torch.tensor(l2),
                  pk_l1_base=torch.tensor([0, 2, 4], dtype=torch.int32),
                  pk_tri=torch.tensor(tris))
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t_max = torch.tensor([3.0e38, 0.0])        # the second lane is dead
    flops, nbytes = k1_work(tables, o, d, t_max)
    # slab tests: both unions, the 2 L1s of the one union entered before
    # t = 1, then the 2 child boxes of the one L1 entered before t = 1;
    # triangle tests: the 2 of the one child block entered before t = 1
    # (child 1 starts at 3, L1 1 at 5; union 1 is never entered)
    assert flops == (2 + 2 + 2) * 20 + 2 * 45
    # one ray in and out, the union table, one union's L1 rows, one L1's
    # child boxes, one block
    assert nbytes == 41 + 2 * 64 + 2 * 36 + 2 * 32 + 2 * 48
    assert bound_s(flops, nbytes) == max(flops / FP32_PEAK,
                                         nbytes / HBM_RATE)


def test_nearest_hits_match_the_plain_walk():
    from pathtracing_tpu_torch.accel.trace2 import (build_tri_blocks2,
                                                    _plain_slots)
    g = torch.Generator().manual_seed(5)
    base = torch.rand((3000, 1, 3), generator=g) * 10
    tri_v = (base + torch.rand((3000, 3, 3), generator=g)).numpy()
    tables = {k: torch.as_tensor(v) for k, v in
              build_tri_blocks2(tri_v)[0].items()}
    o = torch.rand((256, 3), generator=g) * 10 - torch.tensor([0, 0, 5.0])
    d = torch.nn.functional.normalize(torch.randn((256, 3), generator=g),
                                      dim=-1)
    t_max = torch.full((256,), 3.0e38)
    t_ref, _ = _plain_slots(tables, o, d, t_max)
    w = walk(tables, o, d, t_max)
    assert bool((t_ref < 3.0e38).sum() > 20)
    assert torch.allclose(w["best"], t_ref, rtol=1e-5)
    nc = tables["pk_cbox"].shape[0]
    assert w["flops"] >= 256 * nc * 20 and w["bytes"] > 0


def _soup_tables(n_tri, n_ray, seed, k2):
    """Plain two-level tables over a seeded triangle soup, and rays: some
    bounded, some dead."""
    from pathtracing_tpu_torch.accel.trace2 import build_tri_blocks2
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((n_tri, 1, 3), generator=g) * 10
    tri_v = (base + torch.rand((n_tri, 3, 3), generator=g)).numpy()
    tables = {k: torch.as_tensor(v) for k, v in
              build_tri_blocks2(tri_v, k2=k2, g=8)[0].items()}
    o = torch.rand((n_ray, 3), generator=g) * 10 - torch.tensor([0, 0, 5.0])
    d = torch.nn.functional.normalize(torch.randn((n_ray, 3), generator=g),
                                      dim=-1)
    t_max = torch.full((n_ray,), 3.0e38)
    t_max[::5] = 4.0
    t_max[1::17] = 0.0
    return tables, o, d, t_max


# the parent's count on plain tables (before the instanced count): flops,
# bytes, sha256 of `best`'s float32 bytes and its hits; one union of 3
# L1s, then 20 unions of 157
PLAIN = [((3000, 256, 5, None), 3800580.0, 158277.0,
          "ab19b1c4d28a6806d82d4dfb16c5551856f8c0f8de9d673c97a4223c335dd447",
          75),
         ((20000, 512, 9, 16), 2743120.0, 531561.0,
          "98e373d4a5f006e449f22a24f40082aa2a6aff125bb2d9e4b11e440df16e7c59",
          257)]


@pytest.mark.parametrize("case", PLAIN, ids=["one_union", "twenty_unions"])
def test_plain_tables_count_as_before(case):
    args, flops, nbytes, digest, hits = case
    w = walk(*_soup_tables(*args))
    assert w["flops"] == flops and w["bytes"] == nbytes
    assert hashlib.sha256(w["best"].numpy().tobytes()).hexdigest() == digest
    assert int((w["best"] < BIG).sum()) == hits


def _affine(rot, scale, move):
    m = torch.eye(4, dtype=torch.float64)
    m[:3, :3] = rot * scale
    m[:3, 3] = move
    return m


def _field(seed=3, n_world=5000, models=((3000, 150), (800, 120),
                                         (200, 90)), g=16):
    """Instanced two-level tables (the port's build_tri_blocks2_inst):
    n_world world triangles and, per (model triangles, instances), a model
    of small triangles in a unit ball instanced that many times, each
    instance turned about a random axis, scaled (unevenly) and moved.
    Returns (tables, raw) with raw the arrays the reference scans read."""
    from pathtracing_tpu_torch.accel.trace2 import build_tri_blocks2_inst
    gen = torch.Generator().manual_seed(seed)
    world = torch.rand((n_world, 1, 3), generator=gen) * 60 \
        + torch.rand((n_world, 3, 3), generator=gen)
    world[..., 1] *= 0.1                        # a slab of ground clutter
    otri, base, count, fwd, inv = [], [], [], [], []
    first = 0
    for n_tri, n_inst in models:
        c = torch.randn((n_tri, 1, 3), generator=gen)
        c = c / c.norm(dim=-1, keepdim=True)
        otri.append(c * torch.rand((n_tri, 1, 1), generator=gen)
                    + 0.3 * (torch.rand((n_tri, 3, 3), generator=gen) - 0.5))
        for _ in range(n_inst):
            q, _ = torch.linalg.qr(torch.randn((3, 3), generator=gen,
                                               dtype=torch.float64))
            scale = 0.5 + 1.5 * torch.rand(3, generator=gen,
                                           dtype=torch.float64)
            move = torch.rand(3, generator=gen, dtype=torch.float64) \
                * torch.tensor([60.0, 6.0, 60.0], dtype=torch.float64)
            m = _affine(q, scale, move)
            fwd.append(m[:3].float().numpy())
            inv.append(torch.linalg.inv(m)[:3].float().numpy())
            base.append(first)
            count.append(n_tri)
        first += n_tri
    otri = torch.cat(otri)
    tables, _ = build_tri_blocks2_inst(world.numpy(), otri.numpy(), fwd, inv,
                                       base, count, g=g)
    raw = dict(tri_v=world, otri_v=otri,
               inst_fwd=torch.as_tensor(np.stack(fwd)),
               inst_inv=torch.as_tensor(np.stack(inv)),
               inst_base=torch.tensor(base, dtype=torch.int32),
               inst_count=torch.tensor(count, dtype=torch.int32))
    return {k: torch.as_tensor(v) for k, v in tables.items()}, raw


def _rays(n, seed):
    """Rays through the field: from above and from its sides, some
    bounded, some dead."""
    gen = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=gen) * torch.tensor([80.0, 20.0, 80.0]) \
        - torch.tensor([10.0, 2.0, 10.0])
    aim = torch.rand((n, 3), generator=gen) * torch.tensor([60.0, 6.0, 60.0])
    d = torch.nn.functional.normalize(aim - o, dim=-1)
    t_max = torch.full((n,), 3.0e38)
    t_max[::7] = 25.0
    t_max[3::11] = 0.0
    return o, d, t_max


def _reference_nearest(raw, o, d, t_max, instances=True):
    """The nearest hit t by the reference's scans: the world triangles
    (scan.py) and the run-time instances (iscan.py)."""
    z3, z1 = torch.zeros((1, 3)), torch.zeros(1)
    scene = dict(tri_v=raw["tri_v"], sph_c=z3, sph_r=z1, quad_q=z3,
                 quad_u=z3, quad_v=z3, quad_n=z3, quad_d=z1, quad_w=z3)
    best = torch.full((o.shape[0],), BIG)
    ray, _, t, _, _ = Scan(scene, raw["tri_v"].shape[0], 0, 0).tri_hits(
        o, d, t_max)
    best.scatter_reduce_(0, ray, t, reduce="amin")
    if instances:
        ray, _, _, t, _, _ = InstScan(raw).hits(o, d, t_max)
        best.scatter_reduce_(0, ray, t, reduce="amin")
    return best


def _assert_nearest(best, ref):
    assert torch.equal(best < BIG, ref < BIG)
    hit = ref < BIG
    assert bool(((best - ref).abs()[hit]
                 <= T_TOL * ref[hit].clamp(min=1.0)).all())


def test_instanced_nearest_hits_match_the_reference_scans():
    tables, raw = _field()
    assert raw["inst_fwd"].shape[0] == 360
    o, d, t_max = _rays(768, 4)
    w = walk(tables, o, d, t_max)
    live = t_max > 0
    ref = _reference_nearest(raw, o[live], d[live], t_max[live])
    _assert_nearest(w["best"], ref)
    # the rays meet the world and the instances alike
    world = _reference_nearest(raw, o[live], d[live], t_max[live],
                               instances=False)
    on_inst = (ref < world - T_TOL * world.clamp(min=1.0))
    assert int(on_inst.sum()) > 100 and int(((ref == world)
                                             & (ref < BIG)).sum()) > 15
    assert w["flops"] > 0 and w["bytes"] > 0


def test_instanced_tables_of_the_old_failure_are_walked():
    """5,000 world triangles and 300 instances of one 3,000-triangle model:
    an expanded top level of 603 L1s over 5 physical ones (the frozen
    plain walk indexed the physical table with expanded ids and raised
    IndexError)."""
    tables, raw = _field(seed=8, models=((3000, 300),))
    assert tables["pk_l1box"].shape == (603, 8)
    assert tables["pk_l1_base"].shape == (5,)
    o, d, t_max = _rays(256, 9)
    w = walk(tables, o, d, t_max)
    live = t_max > 0
    _assert_nearest(w["best"], _reference_nearest(raw, o[live], d[live],
                                                  t_max[live]))
    assert k1_work(tables, o, d, t_max) == (w["flops"], w["bytes"])


def _relaid(tables, seed):
    """The same instanced tables with their top level laid out otherwise:
    the expanded L1 list shuffled and its coarse unions rebuilt over
    another order."""
    from pathtracing_tpu_torch.accel.build import coarse_tables
    n = tables["pk_l1box"].shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    out = dict(tables)
    for k in ("pk_l1box", "pk_blk_lo", "pk_blk_hi", "pk_blk_src",
              "pk_blk_inst"):
        out[k] = tables[k][perm]
    lo, hi = out["pk_blk_lo"].numpy(), out["pk_blk_hi"].numpy()
    order = np.random.default_rng(seed).permutation(n)
    out.update({k: torch.as_tensor(v)
                for k, v in coarse_tables(lo, hi, order).items()})
    return out


def test_instanced_count_does_not_depend_on_the_top_level_layout():
    from pathtracing_tpu_torch.accel.trace2 import _plain_slots
    tables, _ = _field(seed=5)
    o, d, t_max = _rays(256, 6)
    w = walk(tables, o, d, t_max)
    other = _relaid(tables, 7)
    assert not torch.equal(other["pk_cmem"], tables["pk_cmem"])
    # the re-laid tables are sound tables: the port's plain walk finds
    # the same nearest hits on them
    t0, _ = _plain_slots(tables, o, d, t_max)
    t1, _ = _plain_slots(other, o, d, t_max)
    assert torch.equal(t0, t1)
    w1 = walk(other, o, d, t_max)
    assert (w1["flops"], w1["bytes"]) == (w["flops"], w["bytes"])
    assert torch.equal(w1["best"], w["best"])
    # the count reads the instanced tables' bindings alone
    w2 = walk({k: tables[k] for k in INST_TABLES}, o, d, t_max)
    assert (w2["flops"], w2["bytes"]) == (w["flops"], w["bytes"])
    assert torch.equal(w2["best"], w["best"])


def test_instanced_count_by_hand():
    """One world L1 and one model L1 of two child blocks of two triangles
    (K = 2, G = 2); instances 0 and 1 of the model on the +z axis at
    z = 2 and z = 5, instance 2 far off it.  Ray 0 goes up +z from the
    origin and hits instance 0 at t = 2; ray 1 starts at z = 3 and hits the
    world at t = 0.5; ray 2 goes down and meets nothing; ray 3 is dead."""
    on = [(-1, -1), (1, -1), (0, 1)]            # covers the axis
    off = [(5, -1), (6, -1), (5.5, 1)]          # x in [5, 6]

    def tri(xy, z):
        v = torch.tensor([[x, y, z] for x, y in xy])
        return torch.cat([v[0], v[1] - v[0], v[2] - v[0], torch.zeros(3)])

    def box(lo, hi):
        return list(lo) + [0.0] + list(hi) + [0.0]

    rows = [tri(on, 3.5), tri(off, 3.5), tri(on, 10), tri(off, 10),
            tri(on, 0.0), tri(off, 0.0), tri(off, 0.5), tri(off, 0.5)]
    l2 = [box((-1, -1, 3.5), (6, 1, 3.5)), box((-1, -1, 10), (6, 1, 10)),
          box((-1, -1, 0), (6, 1, 0)), box((5, -1, 0.5), (6, 1, 0.5))]

    def move(z, x=0.0):
        return _affine(torch.eye(3, dtype=torch.float64), 1.0,
                       torch.tensor([x, x, z], dtype=torch.float64))
    maps = [move(2.0), move(5.0), move(0.0, 50.0)]
    tables = dict(pk_tri=torch.stack(rows), pk_l2box=torch.tensor(l2),
                  pk_l1_base=torch.tensor([0, 2], dtype=torch.int32),
                  # the expanded list, repeated and out of order: the map
                  # is a set of (instance, physical L1) pairs
                  pk_blk_src=torch.tensor([1, 0, 1, 1, 1],
                                          dtype=torch.int32),
                  pk_blk_inst=torch.tensor([2, -1, 0, 1, 0],
                                           dtype=torch.int32),
                  pk_inst_fwd=torch.stack([m[:3].reshape(12) for m in maps]
                                          ).float(),
                  pk_inst_inv=torch.stack([torch.linalg.inv(m)[:3].reshape(
                      12) for m in maps]).float())
    o = torch.tensor([[0.0, 0, 0], [0, 0, 3], [0, 0, 0], [0, 0, 0]])
    d = torch.tensor([[0.0, 0, 1], [0, 0, 1], [0, 0, -1], [0, 0, 1]])
    t_max = torch.tensor([3.0e38, 3.0e38, 3.0e38, 0.0])
    w = walk(tables, o, d, t_max)
    assert torch.equal(w["best"], torch.tensor([2.0, 0.5, BIG]))
    # ray 0: instance 0's box (entered at 2, the hit), its model L1's 2
    # child boxes, the 2 triangles of child 2 (child 3 lies off the axis;
    # instance 1 and the world start beyond t = 2); ray 1: the world L1's
    # box, its 2 child boxes, the 2 triangles of child 0 (child 1 starts at
    # 7, instance 1 at 2)
    assert w["flops"] == 2 * (20 + 2 * 20 + 2 * 45)
    # three live rays in and out; instance 0's box and map, the world L1's
    # row; both physical L1s' child boxes; children 2 and 0's rows
    assert w["bytes"] == 3 * 41 + (32 + 48) + 36 + 2 * 2 * 32 + 2 * 2 * 48
