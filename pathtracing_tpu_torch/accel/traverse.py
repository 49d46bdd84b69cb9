"""Per-ray-stack wide-BVH walk (counterpart of
pathtracing_tpu/accel/traverse.py), the backend behind accel="bvh".

Every ray carries a stack of MAX_STACK (node or leaf code, entry
distance) pairs.  One iteration of the loop pops one entry per live ray,
culls it when its entry distance is not before the ray's best hit (the
reference's `entryDist` stack), tests up to LEAF_MAX primitives of a
leaf (Moller-Trumbore, sphere quadratic, quad plane) or slab-tests the W
child boxes of a node and pushes the entered ones farthest first, so the
nearest is popped next.  The loop runs until no ray is live, one host
sync per iteration.

It is plain PyTorch on tensors on the card or the CPU: the reference has
no Pallas kernel here (it is XLA code), so there is nothing hand-written
to port.  The walk is the reference's step for step: the stable sort of
the entry distances (equal ones keep their slot order), the first least t
of a leaf, pushes past MAX_STACK dropped, and the leaf math rounded as
the reference's jitted CPU code rounds it (each cross-product component
and most three-term sums as fused multiply-adds, see `_cross` / `_dot`;
the quad's plane distance with each product rounded, `_dot_plain`), so
the same inputs give the same hits.
"""
from __future__ import annotations

import torch

from ..core.math import BIG_F32, SHADOW_EPS, fma, fsqrt
from ..scene.types import SHAPE_TRI, SHAPE_SPH, SHAPE_QUAD
from .build import W, LEAF_MAX, LEAF_SHIFT, MAX_STACK


def _dot(a, b):
    """Sum over the trailing 3-axis of a * b: the reference's reduction
    accumulates x, y, z in turn as fused multiply-adds."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _dot_plain(a, b):
    """The same sum where the reference rounds each product (its quad
    plane test)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    """a x b over the trailing 3-axis, each component one fused
    multiply-add (the reference's compiled cross product)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], -1)


def _slab_w(o, inv_d, t_min, t_max, lo, hi):
    """Slab test of each ray against its W child boxes: o, inv_d [N,3],
    lo, hi [N,W,3].  Returns the entry distance, or BIG_F32 on a miss;
    empty slots (lo = +inf, hi = -inf) miss explicitly."""
    t0 = (lo - o[:, None, :]) * inv_d[:, None, :]
    t1 = (hi - o[:, None, :]) * inv_d[:, None, :]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    tn = torch.maximum(tn, t_min[:, None])
    tf = torch.minimum(tf, t_max[:, None])
    hit = (tn <= tf) & (lo <= hi).all(-1)
    return torch.where(hit, tn, BIG_F32)


def _tri_leaf(scene, oo, dd, idx):
    """Moller-Trumbore, two-sided, on the leaf's slots: (t, ok)."""
    tv = scene["tri_v"][torch.clamp(idx, 0, scene["tri_v"].shape[0] - 1)]
    e1 = tv[..., 1, :] - tv[..., 0, :]
    e2 = tv[..., 2, :] - tv[..., 0, :]
    h = _cross(dd, e2)
    det = _dot(e1, h)
    near0 = torch.abs(det) < 1e-9
    inv_det = 1.0 / torch.where(near0, 1.0, det)
    s = oo - tv[..., 0, :]
    u = _dot(s, h) * inv_det
    q = _cross(s, e1)
    v = _dot(dd, q) * inv_det
    t = _dot(e2, q) * inv_det
    return t, ~near0 & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)


def _sph_leaf(scene, oo, dd, d, idx, tmn):
    """Sphere quadratic: the near root if it lies beyond t_min, else the
    far one: (t, ok)."""
    si = torch.clamp(idx, 0, scene["sph_c"].shape[0] - 1)
    oc = oo - scene["sph_c"][si]
    a = _dot(d, d)[:, None]
    b = _dot(oc, dd)
    r = scene["sph_r"][si]
    cc = fma(-r, r, _dot(oc, oc))
    disc = fma(b, b, -(a * cc))
    sq = fsqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = torch.where((disc > 0) & (t0 > tmn), t0, t1)
    return t, (disc > 0) & (t > tmn)


def _quad_leaf(scene, oo, dd, idx):
    """Two-sided parallelogram: (t, ok)."""
    qi = torch.clamp(idx, 0, scene["quad_q"].shape[0] - 1)
    qn = scene["quad_n"][qi]
    flip = _dot_plain(dd, qn) > 0
    nn = torch.where(flip[..., None], -qn, qn)
    dd_s = torch.where(flip, -scene["quad_d"][qi], scene["quad_d"][qi])
    denom = _dot_plain(nn, dd)
    small = torch.abs(denom) < 1e-8
    t = (dd_s - _dot_plain(nn, oo)) / torch.where(small, 1.0, denom)
    pq = fma(t[..., None], dd, oo) - scene["quad_q"][qi]
    w = scene["quad_w"][qi]
    alpha = _dot(w, _cross(pq, scene["quad_v"][qi]))
    beta = _dot(w, _cross(scene["quad_u"][qi], pq))
    return t, (~small & (alpha >= 0) & (alpha <= 1) & (beta >= 0)
               & (beta <= 1))


def _leaf_test(scene, o, d, t_min, t_max, base, count, shapes):
    """Test up to LEAF_MAX primitives (prim table order) per ray.
    Returns (t, kind, idx, valid) of the first closest hit in the leaf.
    shapes = (has_tri, has_sph, has_quad): absent kinds are not tested."""
    slots = torch.arange(LEAF_MAX, device=o.device)[None, :]
    pidx = torch.clamp(base[:, None] + slots, 0,
                       scene["prim_kind"].shape[0] - 1)
    live = slots < count[:, None]
    kind = scene["prim_kind"][pidx].to(torch.int64)
    idx = scene["prim_idx"][pidx].to(torch.int64)
    oo, dd = o[:, None, :], d[:, None, :]
    tmn, tmx = t_min[:, None], t_max[:, None]

    has_tri, has_sph, has_quad = shapes
    t = torch.full(kind.shape, BIG_F32, dtype=torch.float32, device=o.device)
    ok = torch.zeros(kind.shape, dtype=torch.bool, device=o.device)
    if has_tri:
        sel = kind == SHAPE_TRI
        tt, okt = _tri_leaf(scene, oo, dd, idx)
        t, ok = torch.where(sel, tt, t), torch.where(sel, okt, ok)
    if has_sph:
        sel = kind == SHAPE_SPH
        ts, oks = _sph_leaf(scene, oo, dd, d, idx, tmn)
        t, ok = torch.where(sel, ts, t), torch.where(sel, oks, ok)
    if has_quad:
        sel = kind == SHAPE_QUAD
        tq, okq = _quad_leaf(scene, oo, dd, idx)
        t, ok = torch.where(sel, tq, t), torch.where(sel, okq, ok)
    ok = ok & live & (t >= tmn) & (t < tmx)
    t = torch.where(ok, t, BIG_F32)
    j = torch.argmin(t, dim=1, keepdim=True)          # first least t
    return (t.gather(1, j)[:, 0], kind.gather(1, j)[:, 0],
            idx.gather(1, j)[:, 0], ok.gather(1, j)[:, 0])


def bvh_intersect(scene, origin, direction, t_max, t_min=None,
                  any_hit: bool = False, shapes=(True, True, True),
                  stats: dict | None = None):
    """Closest-hit (or any-hit) wide-BVH walk for a ray batch [N]:
    dict(t, kind, idx, valid), t = BIG_F32 and kind = -1 on a miss.
    any_hit ends a ray at its first accepted hit (shadow rays: no
    front-to-back order needed).  shapes = (has_tri, has_sph, has_quad):
    the kinds the scene holds (the others are not tested).  stats, when
    given, gets "iterations" (loop iterations run, one host sync each)."""
    n = origin.shape[0]
    dev = origin.device
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    t_min = (torch.full((n,), SHADOW_EPS, dtype=torch.float32, device=dev)
             if t_min is None else torch.broadcast_to(
                 torch.as_tensor(t_min, dtype=torch.float32, device=dev),
                 (n,)))
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    tiny = torch.where(direction < 0, -1e-32, 1e-32)
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-32, tiny, direction)

    # one spare column takes the pushes past MAX_STACK (dropped)
    stack_n = torch.zeros((n, MAX_STACK + 1), dtype=torch.int64, device=dev)
    stack_t = torch.full((n, MAX_STACK + 1), BIG_F32, dtype=torch.float32,
                         device=dev)
    stack_t[:, 0] = 0.0                                  # the root
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = t_max.clone()
    best_kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)
    n_nodes = scene["bvh_lo"].shape[0]
    iterations = 0
    while True:
        active = ~done & (sp > 0)
        if not bool(active.any()):
            break
        iterations += 1
        spi = torch.clamp(sp - 1, 0, MAX_STACK - 1)     # gathers clamp
        code = stack_n[lane, spi]
        entry = stack_t[lane, spi]
        sp = torch.where(active, sp - 1, sp)
        work = active & ~(entry >= best_t)      # t-max culling at pop
        is_leaf = code < 0

        # leaf: primitive tests
        leaf_val = -(code + 1)
        cnt = torch.where(work & is_leaf, leaf_val % LEAF_SHIFT, 0)
        lt, lk, li, lok = _leaf_test(scene, origin, direction, t_min,
                                     best_t, leaf_val // LEAF_SHIFT, cnt,
                                     shapes)
        better = lok & (lt < best_t) & work & is_leaf
        best_t = torch.where(better, lt, best_t)
        best_kind = torch.where(better, lk, best_kind)
        best_idx = torch.where(better, li, best_idx)
        if any_hit:
            done = done | better

        # internal node: child slab tests, entered children pushed
        # farthest first (nearest on top)
        node = torch.clamp(code, 0, n_nodes - 1)
        dist = _slab_w(origin, inv_d, t_min, best_t, scene["bvh_lo"][node],
                       scene["bvh_hi"][node])
        is_int = work & ~is_leaf
        dist = torch.where(is_int[:, None], dist, BIG_F32)
        ordr = torch.argsort(-dist, dim=1, stable=True)
        d_sorted = dist.gather(1, ordr)
        c_sorted = scene["bvh_child"][node].to(torch.int64).gather(1, ordr)
        h_sorted = d_sorted < BIG_F32
        pos = sp[:, None] + torch.cumsum(h_sorted.to(torch.int64), 1) - 1
        pos = torch.where(h_sorted, torch.clamp(pos, max=MAX_STACK),
                          MAX_STACK)
        rows = lane[:, None].expand(n, W)
        stack_n[rows, pos] = c_sorted
        stack_t[rows, pos] = d_sorted
        sp = torch.where(is_int, sp + h_sorted.sum(1), sp)
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iterations
    valid = best_kind >= 0
    return dict(t=torch.where(valid, best_t, BIG_F32), kind=best_kind,
                idx=best_idx, valid=valid)
