"""Beam traversal over a flat block cut of the SAH order (counterpart of
pathtracing_tpu/accel/beam.py).

The builder puts the scene's primitives (triangles, spheres, quads) in the
SAH builder's leaf order and cuts it into blocks of K consecutive prims
(`build_blocks`, through accel/build.py::build_beam); each block's box is
one entry of a flat top level.  A ray slab-tests every block box, sorts
the entered ones front to back once, and walks them in that order,
testing the K prims of one block per step, until the next block's entry
is beyond its best hit (any-hit: until the first hit).  The reference
package picks this backend for triangle-free scenes of 4,096 prims or
more (scene/builder.py, accel="auto").

It is plain PyTorch on tensors on the card or the CPU: the reference has
no Pallas kernel here, so there is nothing hand-written to port.  The
arithmetic, the sort (stable, ties to the least block) and the tie rule
(within a block the first prim of least t, across blocks the earlier
block) are the reference's, with multiply-adds rounded where its jitted
CPU code fuses them (as in scene/intersect.py's brute tests), so the same
inputs give the same hits.  Rays are processed in chunks, each running
the reference's lock-step loop until none of its lanes is live.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import BIG_F32, SHADOW_EPS, _inv_guard, fma, fsqrt

SHAPE_TRI, SHAPE_SPH, SHAPE_QUAD = 0, 1, 2
BEAM_B = 1        # blocks tested per step


# ---------------------------------------------------------------------------
# Build: cut the SAH order into blocks (host side, NumPy)
# ---------------------------------------------------------------------------

def pick_block_k(n_prims: int) -> int:
    """Balance the M block tests against the K prim tests per visited
    block: M ~ sqrt(2n), K = n / M rounded up to a multiple of 8, M at
    most 4096."""
    m = int(np.clip(2 ** int(np.ceil(np.log2(max(np.sqrt(2.0 * n_prims),
                                                 1.0)))), 64, 4096))
    k = -(-n_prims // m)
    return max(8, -(-k // 8) * 8)


def build_blocks(lo, hi, kinds, idxs, order, block_k: int | None = None):
    """Group the SAH-ordered prims into blocks of block_k.  Returns (dict
    of arrays, M):
      blk_lo/hi [M, 3]   block bounds
      blk_base  [M]      first prim (in SAH order) of each block
      blk_k     [1]      prims per block
      prim_kind / prim_idx [M*K]  SAH-ordered prim tables; padded slots
                         repeat the last prim with kind -1"""
    n = len(order)
    k = block_k or pick_block_k(n)
    m = -(-n // k)
    pad = m * k - n
    ord_pad = np.concatenate([order, np.repeat(order[-1:], pad)])
    blk_lo = lo[ord_pad].reshape(m, k, 3).min(1)
    blk_hi = hi[ord_pad].reshape(m, k, 3).max(1)
    kind_pad = kinds[ord_pad].astype(np.int32)
    idx_pad = idxs[ord_pad].astype(np.int32)
    if pad:
        kind_pad[n:] = -1
    return dict(
        blk_lo=blk_lo.astype(np.float32), blk_hi=blk_hi.astype(np.float32),
        blk_base=np.arange(m, dtype=np.int32) * k,
        blk_k=np.asarray([k], np.int32),
        prim_kind=kind_pad, prim_idx=idx_pad), m


def beam_tables(tri_v=None, sph_c=None, sph_r=None, quad_q=None,
                quad_u=None, quad_v=None, quad_n=None, quad_d=None,
                quad_w=None):
    """Component-first geometry tables: beam_tri [9, T] (v0, e1, e2),
    beam_sph [4, S] (center, radius), beam_quad [16, Q] (n, d, q, u, v,
    w); one zero column for an absent shape."""
    if tri_v is not None and len(tri_v):
        tv = np.asarray(tri_v, np.float32)
        v0 = tv[:, 0]
        tri9 = np.concatenate([v0.T, (tv[:, 1] - v0).T, (tv[:, 2] - v0).T], 0)
    else:
        tri9 = np.zeros((9, 1), np.float32)
    if sph_c is not None and len(sph_c):
        sph4 = np.concatenate([np.asarray(sph_c, np.float32).T,
                               np.asarray(sph_r, np.float32)[None]], 0)
    else:
        sph4 = np.zeros((4, 1), np.float32)
    if quad_q is not None and len(quad_q):
        quad16 = np.concatenate(
            [np.asarray(quad_n, np.float32).T,
             np.asarray(quad_d, np.float32)[None],
             np.asarray(quad_q, np.float32).T,
             np.asarray(quad_u, np.float32).T,
             np.asarray(quad_v, np.float32).T,
             np.asarray(quad_w, np.float32).T], 0)
    else:
        quad16 = np.zeros((16, 1), np.float32)
    return dict(beam_tri=tri9.copy(), beam_sph=sph4.copy(),
                beam_quad=quad16.copy())


# ---------------------------------------------------------------------------
# Prim tests on gathered [N, C] components
# ---------------------------------------------------------------------------

def _gather(table, idx):
    """Rows of a component-first table [R, P] at idx [N, C] -> [R, N, C]."""
    return table[:, torch.clamp(idx, 0, table.shape[1] - 1)]


def _tri_block(scene, ox, oy, oz, dx, dy, dz, idx):
    """Two-sided Moller-Trumbore."""
    g = _gather(scene["beam_tri"], idx)
    ax, ay, az = g[0], g[1], g[2]
    e1x, e1y, e1z = g[3], g[4], g[5]
    e2x, e2y, e2z = g[6], g[7], g[8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    near0 = torch.abs(det) < 1e-9
    inv_det = 1.0 / torch.where(near0, 1.0, det)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return t, ~near0 & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)


def _sph_block(scene, ox, oy, oz, dx, dy, dz, tmn, idx):
    """Quadratic sphere test: the near root if it lies beyond t_min, else
    the far one."""
    g = _gather(scene["beam_sph"], idx)
    ocx, ocy, ocz = ox - g[0], oy - g[1], oz - g[2]
    r = g[3]
    a = fma(dz, dz, fma(dx, dx, dy * dy))
    b = fma(ocz, dz, fma(ocx, dx, ocy * dy))
    cc = fma(ocz, ocz, fma(ocx, ocx, ocy * ocy)) - r * r
    disc = fma(b, b, -(a * cc))
    sq = fsqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = torch.where((disc > 0) & (t0 > tmn), t0, t1)
    return t, (disc > 0) & (t > tmn)


def _quad_block(scene, ox, oy, oz, dx, dy, dz, idx):
    """Two-sided parallelogram test."""
    g = _gather(scene["beam_quad"], idx)
    nx, ny, nz, qd = g[0], g[1], g[2], g[3]
    ddn = fma(dz, nz, fma(dx, nx, dy * ny))
    sgn = torch.where(ddn > 0, -1.0, 1.0)
    nx, ny, nz, qd, ddn = nx * sgn, ny * sgn, nz * sgn, qd * sgn, ddn * sgn
    small = torch.abs(ddn) < 1e-8
    t = ((qd - fma(nz, oz, fma(nx, ox, ny * oy)))
         / torch.where(small, 1.0, ddn))
    px = fma(t, dx, ox) - g[4]
    py = fma(t, dy, oy) - g[5]
    pz = fma(t, dz, oz) - g[6]
    ux, uy, uz = g[7], g[8], g[9]
    vx, vy, vz = g[10], g[11], g[12]
    wx, wy, wz = g[13], g[14], g[15]
    # alpha = w . (p x v); beta = w . (u x p)
    alpha = fma(wz, fma(px, vy, -(py * vx)),
                fma(wx, fma(py, vz, -(pz * vy)), wy * fma(pz, vx, -(px * vz))))
    beta = fma(wz, fma(ux, py, -(uy * px)),
               fma(wx, fma(uy, pz, -(uz * py)), wy * fma(uz, px, -(ux * pz))))
    return t, ~small & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)


def _prim_test(scene, ray, t_min, kind, idx, shapes):
    """Test prims (kind, idx) [N, C] against rays [N]: (t, ok), t = BIG_F32
    where not ok.  Absent shape kinds (shapes = (has_tri, has_sph,
    has_quad)) are not gathered."""
    ox, oy, oz, dx, dy, dz = ray
    tmn = t_min[:, None]
    has_tri, has_sph, has_quad = shapes
    t = torch.full(kind.shape, BIG_F32, dtype=torch.float32,
                   device=kind.device)
    ok = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)
    if has_tri:
        tt, okt = _tri_block(scene, ox, oy, oz, dx, dy, dz, idx)
        sel = kind == SHAPE_TRI
        t, ok = torch.where(sel, tt, t), torch.where(sel, okt, ok)
    if has_sph:
        ts, oks = _sph_block(scene, ox, oy, oz, dx, dy, dz, tmn, idx)
        sel = kind == SHAPE_SPH
        t, ok = torch.where(sel, ts, t), torch.where(sel, oks, ok)
    if has_quad:
        tq, okq = _quad_block(scene, ox, oy, oz, dx, dy, dz, idx)
        sel = kind == SHAPE_QUAD
        t, ok = torch.where(sel, tq, t), torch.where(sel, okq, ok)
    ok = ok & (kind >= 0) & (t >= tmn)
    return torch.where(ok, t, BIG_F32), ok


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _beam_chunk(scene, o, d, t_min, t_max, k, any_hit, shapes):
    """The reference's lock-step walk over one chunk of rays."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ix, iy, iz = _inv_guard(d).unbind(1)
    blo, bhi = scene["blk_lo"], scene["blk_hi"]
    m = blo.shape[0]

    def axis_slab(a, o_a, inv_a):
        u0 = (blo[None, :, a] - o_a[:, None]) * inv_a[:, None]
        u1 = (bhi[None, :, a] - o_a[:, None]) * inv_a[:, None]
        return torch.minimum(u0, u1), torch.maximum(u0, u1)

    n0, f0 = axis_slab(0, ox, ix)
    n1, f1 = axis_slab(1, oy, iy)
    n2, f2 = axis_slab(2, oz, iz)
    tn = torch.maximum(torch.maximum(n0, n1),
                       torch.maximum(n2, t_min[:, None]))
    tf = torch.minimum(torch.minimum(f0, f1),
                       torch.minimum(f2, t_max[:, None]))
    entry = torch.where(tn <= tf, tn, BIG_F32)             # [N, M]
    del n0, f0, n1, f1, n2, f2, tn, tf
    order = torch.argsort(entry, dim=1, stable=True)       # front to back
    entry_sorted = torch.gather(entry, 1, order)
    del entry

    ray = (ox[:, None], oy[:, None], oz[:, None],
           dx[:, None], dy[:, None], dz[:, None])
    base_of = scene["blk_base"].to(torch.int64)
    prim_kind, prim_idx = scene["prim_kind"], scene["prim_idx"]
    slot = torch.arange(k, dtype=torch.int64, device=dev)
    lane = torch.arange(n, device=dev)
    best_t = t_max.clone()
    best_kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    for s0 in range(0, m, BEAM_B):
        if not bool(live.any()):
            break
        blocks = order[:, s0:s0 + BEAM_B]
        ents = entry_sorted[:, s0:s0 + BEAM_B]
        # lanes whose nearest unprocessed block is beyond the best hit
        live = live & (ents[:, 0] < best_t)
        useful = ents < best_t[:, None]
        nb = blocks.shape[1]
        pidx = (base_of[blocks][..., None] + slot).reshape(n, nb * k)
        pmask = torch.repeat_interleave(useful & live[:, None], k, dim=1)
        pidx = torch.clamp(pidx, 0, prim_kind.shape[0] - 1)
        kind = torch.where(pmask, prim_kind[pidx].to(torch.int64), -1)
        idx = prim_idx[pidx].to(torch.int64)
        t, _ = _prim_test(scene, ray, t_min, kind, idx, shapes)
        t = torch.where(t < best_t[:, None], t, BIG_F32)
        j = torch.argmin(t, dim=1)                         # first least t
        tj = t[lane, j]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_kind = torch.where(better, kind[lane, j], best_kind)
        best_idx = torch.where(better, idx[lane, j], best_idx)
        if any_hit:
            live = live & ~better
    return best_t, best_kind, best_idx


def beam_intersect(scene, origin, direction, t_max, block_k: int,
                   t_min=None, any_hit: bool = False,
                   shapes=(True, True, True)):
    """Closest-hit (or any-hit) beam traversal: dict(t, kind, idx, valid),
    t = BIG_F32 and kind = -1 on a miss.  block_k: the prims per block the
    scene was built with (SceneMeta.block_k); shapes: (has_tri, has_sph,
    has_quad)."""
    n = origin.shape[0]
    dev = origin.device
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    t_min = (torch.full((n,), SHADOW_EPS, dtype=torch.float32, device=dev)
             if t_min is None else torch.broadcast_to(
                 torch.as_tensor(t_min, dtype=torch.float32, device=dev),
                 (n,)))
    m = scene["blk_lo"].shape[0]
    # [chunk, M] slab temporaries of ~1M elements on the CPU, ~16M on a card
    chunk = max(1, (1 << (24 if origin.is_cuda else 20)) // max(m, 1))
    outs = [_beam_chunk(scene, origin[r0:r0 + chunk],
                        direction[r0:r0 + chunk], t_min[r0:r0 + chunk],
                        t_max[r0:r0 + chunk], block_k, any_hit, shapes)
            for r0 in range(0, n, chunk)]
    best_t, kind, idx = (torch.cat(x) for x in zip(*outs)) if outs else (
        t_max.clone(), torch.full((0,), -1, dtype=torch.int64, device=dev),
        torch.zeros((0,), dtype=torch.int64, device=dev))
    valid = kind >= 0
    return dict(t=torch.where(valid, best_t, BIG_F32), kind=kind, idx=idx,
                valid=valid)
