"""The least time a traversal dispatch could take on the card, from the
work its rays really did (the kernels' per-ray counters).

    bound = traversal_bound(scene, res, n_rays, timed=False)

`scene` holds the traversal tables the dispatch ran on (two-level:
accel/trace2.py, with "pk_l1box"; single-level: accel/trace1.py), `res`
the wrapper's result with counters=True ("counters" [N,5] and the
touched masks).  The bound is the larger of the fp32 operations over the
card's fp32 peak and the bytes over its memory rate:

  operations  the slab tests the kernel counted at the top level (coarse
              unions and entries of its front), G child boxes per L1
              visit, K Moller-Trumbore tests per leaf block visited and
              one cell lookup per mask lookup;
  bytes       rays in (28 B, + 4 with a time, + 4 on instanced tables)
              and results out (8 B) once each, the top-level table and its
              coarse unions once, the child boxes of every physical L1 and
              the triangle rows of every physical block some ray visited
              once, one 48 B inverse transform per visited expanded entry
              of instanced tables, and 32 B of mask words per lookup.

chip_smoke.py's [bound] rows and bench.py's bounce row read this one
count.  The rates are the H100 SXM's.
"""
from __future__ import annotations

import torch

FP32_PEAK = 67e12     # H100 SXM fp32 (non-tensor) FLOP/s
HBM_RATE = 3.35e12    # H100 SXM HBM3 bytes/s
SLAB_FLOPS = 20       # one ray/box slab test
MT_FLOPS = 45         # one ray/triangle Moller-Trumbore test
MASK_FLOPS = 20       # one alpha-cell lookup (affine map, bit tests)
MASK_BYTES = 32       # mask words of one slot
COARSE_G = 8          # top-level entries per coarse union


def _ms(flops, nbytes):
    return flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3


def traversal_bound(scene, res, n: int, timed: bool = False) -> dict:
    """The bound of one dispatch of n rays: dict(bound_ms, bound_by
    ("operations" or "bytes"), ops_ms, bytes_ms, flops, bytes, per_ray
    (the counters' means by name), what (a one-line account)); on
    single-level tables also bound_ms_flat_scan, the bound of a flat scan
    of every block per front refill.  timed: the rays carry a time
    (motion)."""
    cnt = [float(x) for x in res["counters"].to(torch.float64).sum(0)]
    inst = "pk_blk_src" in scene
    ray_bytes = n * (28 + 8 + (4 if timed else 0) + (4 if inst else 0))
    out = {}
    if "pk_l1box" in scene:                     # two-level
        m1 = scene["pk_l1box"].shape[0]
        m2 = scene["pk_l2box"].shape[0]
        g = m2 // scene["pk_l1_base"].shape[0]
        k2 = scene["pk_tri"].shape[0] // m2
        flops = (cnt[4] * SLAB_FLOPS + cnt[1] * g * SLAB_FLOPS
                 + cnt[2] * k2 * MT_FLOPS + cnt[3] * MASK_FLOPS)
        top_seen = int(res["l1_touched"].sum())
        phys_seen = top_seen
        if inst:     # distinct physical L1s among the visited expanded ones
            phys_seen = int(torch.unique(
                scene["pk_blk_src"][res["l1_touched"]]).numel())
        leaf_seen = int(res["leaf_touched"].sum())
        nc = -(-m1 // COARSE_G)
        nbytes = (ray_bytes + m1 * (36 + (8 if inst else 0)) + nc * 32
                  + phys_seen * g * 32 + (top_seen * 48 if inst else 0)
                  + leaf_seen * k2 * 48 + cnt[3] * MASK_BYTES)
        names = ("top_refills", "l1_visits", "leaf_blocks", "mask_lookups",
                 "top_slab_tests")
        what = (f"top refills={cnt[0] / n:.2f} top slab tests="
                f"{cnt[4] / n:.1f} (flat scan: {cnt[0] / n * m1:.0f}) "
                f"L1 visits={cnt[1] / n:.2f} leaf blocks={cnt[2] / n:.2f} "
                f"(tri tests={cnt[2] / n * k2:.0f}) mask lookups="
                f"{cnt[3] / n:.3f}; L1s visited {top_seen}/{m1} (physical "
                f"{phys_seen}), child blocks visited {leaf_seen}/{m2}")
    else:                                       # single-level
        m = scene["pk_blkbox"].shape[0]
        mp, k = scene["pk_tri"].shape[:2]
        nc = scene["pk_cbox"].shape[0]
        leaf = cnt[1] * k * MT_FLOPS + cnt[3] * MASK_FLOPS
        flops = cnt[4] * SLAB_FLOPS + leaf
        seen = int(res["blocks_touched"].sum())
        nbytes = (ray_bytes + m * (32 + (8 if inst else 0)) + nc * 32
                  + seen * k * 48 + (seen * 48 if inst else 0)
                  + cnt[3] * MASK_BYTES)
        flat = max(_ms(cnt[0] * m * SLAB_FLOPS + leaf, nbytes - nc * 32))
        out["bound_ms_flat_scan"] = flat
        names = ("front_refills", "blocks_visited", "blocks_visited_again",
                 "mask_lookups", "top_slab_tests")
        what = (f"front refills={cnt[0] / n:.2f} top slab tests="
                f"{cnt[4] / n:.1f} (flat scan: {cnt[0] / n * m:.0f}) blocks "
                f"visited={cnt[1] / n:.2f} (tri tests={cnt[1] / n * k:.0f}) "
                f"mask lookups={cnt[3] / n:.3f}; physical blocks visited "
                f"{seen}/{mp}; flat-scan bound {flat:.4f} ms")
    ops_ms, bytes_ms = _ms(flops, nbytes)
    out.update(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops_ms=ops_ms, bytes_ms=bytes_ms, flops=flops, bytes=nbytes,
               per_ray={name: c / n for name, c in zip(names, cnt)}, what=what)
    return out
