"""The frozen count of K1's work against a hand count, and its nearest
hits against the port's plain two-level walk."""
from __future__ import annotations

import torch

from rtbench.roofline import k1_work, walk, bound_s, FP32_PEAK, HBM_RATE


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
