"""Host-side SAH build helpers (counterpart of the parts of
pathtracing_tpu/accel/build.py that the traversal tables need).

`_sah_build_binary` is the NumPy binned-SAH builder the C++ builder
(native/bvh_builder.cpp) mirrors; it is the fallback when no C++
toolchain is available.  `sah_order` is the SAH leaf order of a set of
boxes.  `sort_key_coarse` builds coarse unions of consecutive top-level
blocks; `coarse_tables` adds the traversal kernels' coarse front over
them.  `build_beam` is build_bvh's block cut for the beam backend
(accel/beam.py).
"""
from __future__ import annotations

import numpy as np

LEAF_MAX = 4     # max primitives per leaf
LEAF_SHIFT = 8   # leaf encoding bound: SAH leaves hold < LEAF_SHIFT prims


def _sah_build_binary(lo, hi, leaf_size=LEAF_MAX):
    """Returns (nodes, order): nodes is a list of dicts
    {lo, hi, left, right, start, count}; `order` is the permuted prim index
    array; leaves have left == -1 and [start, start+count) in `order`."""
    n = lo.shape[0]
    centroid = 0.5 * (lo + hi)
    order = np.arange(n, dtype=np.int64)
    nodes = []

    def new_node():
        nodes.append(dict(lo=None, hi=None, left=-1, right=-1,
                          start=0, count=0))
        return len(nodes) - 1

    root = new_node()
    # iterative stack build (recursion depth can exceed CPython's limit)
    stack = [(root, 0, n)]
    while stack:
        ni, s, e = stack.pop()
        span = e - s
        idx = order[s:e]
        blo = lo[idx].min(0)
        bhi = hi[idx].max(0)
        nodes[ni]["lo"], nodes[ni]["hi"] = blo, bhi
        if span <= leaf_size:
            nodes[ni].update(start=s, count=span)
            continue

        c = centroid[idx]
        clo, chi = c.min(0), c.max(0)
        cext = chi - clo
        n_bins = 32 if span >= 1024 else (16 if span >= 64 else 8)

        best = (np.inf, -1, -1)  # cost, axis, bin split
        bin_of_axis = {}
        for axis in range(3):
            if cext[axis] <= 1e-12:
                continue
            b = np.minimum(((c[:, axis] - clo[axis]) / cext[axis]
                            * n_bins).astype(np.int64), n_bins - 1)
            bin_of_axis[axis] = b
            # per-bin bbox + count via np.minimum.at
            blo_b = np.full((n_bins, 3), np.inf)
            bhi_b = np.full((n_bins, 3), -np.inf)
            cnt = np.zeros(n_bins, np.int64)
            np.minimum.at(blo_b, b, lo[idx])
            np.maximum.at(bhi_b, b, hi[idx])
            np.add.at(cnt, b, 1)
            # prefix/suffix sweeps
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = span - lcnt
            llo = np.minimum.accumulate(blo_b, 0)[:-1]
            lhi = np.maximum.accumulate(bhi_b, 0)[:-1]
            rlo = np.minimum.accumulate(blo_b[::-1], 0)[::-1][1:]
            rhi = np.maximum.accumulate(bhi_b[::-1], 0)[::-1][1:]

            def area(alo, ahi):
                d = np.maximum(ahi - alo, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] \
                    + d[:, 2] * d[:, 0]

            cost = area(llo, lhi) * lcnt + area(rlo, rhi) * rcnt
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if cost[k] < best[0]:
                best = (cost[k], axis, k)

        d = np.maximum(bhi - blo, 0.0)
        parent_area = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
        # SAH termination (BVH.hpp:356-360): make a leaf when splitting
        # costs more than testing all prims — but only if the count still
        # fits the leaf encoding.
        leaf_cost = span * parent_area
        if best[1] >= 0 and best[0] >= leaf_cost and span < LEAF_SHIFT:
            nodes[ni].update(start=s, count=span)
            continue
        if best[1] < 0:
            # all centroids coincide: median split to bound depth
            mid = s + span // 2
        else:
            axis, k = best[1], best[2]
            b = bin_of_axis[axis]
            mask = b <= k
            mid = s + int(mask.sum())
            order[s:e] = np.concatenate([idx[mask], idx[~mask]])
            if mid == s or mid == e:
                mid = s + span // 2
        li, ri = new_node(), new_node()
        nodes[ni]["left"], nodes[ni]["right"] = li, ri
        stack.append((ri, mid, e))
        stack.append((li, s, mid))
    return nodes, order


SORT_COARSE_G = 8


def sort_key_coarse(lo: np.ndarray, hi: np.ndarray,
                    group: int = SORT_COARSE_G):
    """Coarse unions of `group` consecutive top-level blocks (SAH order
    keeps consecutive unions tight).  The tables carry them like the
    reference package's; this package's dispatch sort key uses the flat
    per-block scan only."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    m = len(lo)
    mc = -(-m // group)
    pad = mc * group - m
    lop = np.concatenate([lo, np.full((pad, 3), np.inf, np.float32)])
    hip = np.concatenate([hi, np.full((pad, 3), -np.inf, np.float32)])
    clo = lop.reshape(mc, group, 3).min(1)
    chi = hip.reshape(mc, group, 3).max(1)
    return dict(pk_sblk_lo=clo, pk_sblk_hi=chi)


def sah_order(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """SAH leaf order of the boxes (lo, hi) [n,3]: the threaded C++
    builder when it is available, else the NumPy one (the same order)."""
    from ..native.loader import native_build_bvh

    native = native_build_bvh(lo, hi, LEAF_MAX)
    if native is not None:
        return native[3]
    return _sah_build_binary(lo, hi, leaf_size=LEAF_MAX)[1]


COARSE_G = SORT_COARSE_G   # top-level entries per coarse union (the front)


def coarse_tables(lo, hi, order=None):
    """The top level's coarse unions: pk_sblk_lo / pk_sblk_hi, the unions
    of 8 consecutive boxes (sort_key_coarse, the dispatch sort key's), and
    the traversal kernels' front: pk_cbox [nc, 8] f32 (lo xyz, the bits
    of the least member, hi xyz, 0), pk_cmem [nc, 8] i32 (each union's
    members, ascending, -1 padded) and pk_cgrp [m] i32 (the union of each
    entry): the unions of 8 consecutive boxes of `order` (None: the
    table's own order, so pk_cbox holds the pk_sblk boxes).  World tables
    are in SAH order already; an instanced table's entries are in
    instance order, so its builder passes their SAH order: unions of
    entries far apart would be entered by almost every ray."""
    m = len(lo)
    order = np.arange(m) if order is None else np.asarray(order)
    nc = -(-m // COARSE_G)
    mem = np.concatenate([order, np.full(nc * COARSE_G - m, -1)])
    mem = mem.reshape(nc, COARSE_G)
    mem = np.sort(np.where(mem < 0, m, mem), axis=1)   # ascending, pad last
    mem = np.where(mem >= m, -1, mem).astype(np.int32)
    safe = np.maximum(mem, 0)
    box = np.zeros((nc, 8), np.float32)
    box[:, 0:3] = np.where((mem >= 0)[..., None], lo[safe], np.inf).min(1)
    box[:, 4:7] = np.where((mem >= 0)[..., None], hi[safe], -np.inf).max(1)
    box[:, 3] = mem[:, 0].view(np.float32)
    grp = np.empty(m, np.int32)
    grp[mem[mem >= 0]] = np.nonzero(mem >= 0)[0]
    return dict(sort_key_coarse(lo, hi), pk_cbox=box, pk_cmem=mem,
                pk_cgrp=grp)


def _prim_bounds(host_arrays):
    """Boxes, kinds (0 triangle, 1 sphere, 2 quad) and indices of every
    primitive of the host arrays, triangles first; None when empty."""
    los, his, kinds, idxs = [], [], [], []
    tri_v = host_arrays.get("tri_v")
    if tri_v is not None and len(tri_v):
        v = np.asarray(tri_v)
        los.append(v.min(1))
        his.append(v.max(1))
        kinds.append(np.zeros(len(v), np.int64))
        idxs.append(np.arange(len(v), dtype=np.int64))
    sph_c = host_arrays.get("sph_c")
    if sph_c is not None and len(sph_c):
        c = np.asarray(sph_c)
        r = np.asarray(host_arrays["sph_r"])[:, None]
        los.append(c - r)
        his.append(c + r)
        kinds.append(np.ones(len(c), np.int64))
        idxs.append(np.arange(len(c), dtype=np.int64))
    quad_q = host_arrays.get("quad_q")
    if quad_q is not None and len(quad_q):
        q = np.asarray(quad_q)
        u = np.asarray(host_arrays["quad_u"])
        v2 = np.asarray(host_arrays["quad_v"])
        pts = np.stack([q, q + u, q + v2, q + u + v2], 1)
        lo, hi = pts.min(1), pts.max(1)
        # pad degenerate axes so the slab test stays well-conditioned
        pad = 1e-4 * np.maximum((hi - lo).max(-1, keepdims=True), 1e-3)
        los.append(lo - pad)
        his.append(hi + pad)
        kinds.append(np.full(len(q), 2, np.int64))
        idxs.append(np.arange(len(q), dtype=np.int64))
    if not los:
        return None
    return (np.concatenate(los).astype(np.float32),
            np.concatenate(his).astype(np.float32),
            np.concatenate(kinds), np.concatenate(idxs))


def build_beam(host_arrays):
    """The beam backend's tables (the reference's build_bvh without its
    wide-BVH arrays, which only its per-ray-stack backend reads):
    host_arrays holds tri_v / sph_c / sph_r / quad_q / quad_u / quad_v at
    their real lengths (NumPy, None when absent).  Returns (arrays,
    block_k): accel/beam.py's build_blocks over the SAH order of every
    primitive, and its beam_tables (quad plane data derived from q, u, v
    as the reference derives it)."""
    from .beam import build_blocks, beam_tables

    pb = _prim_bounds(host_arrays)
    if pb is None:
        raise ValueError("empty scene")
    lo, hi, kinds, idxs = pb
    arrays, _ = build_blocks(lo, hi, kinds, idxs, sah_order(lo, hi))
    quad = {}
    if host_arrays.get("quad_q") is not None:
        q = np.asarray(host_arrays["quad_q"], np.float32)
        u = np.asarray(host_arrays["quad_u"], np.float32)
        v = np.asarray(host_arrays["quad_v"], np.float32)
        raw = np.cross(u, v)
        len2 = np.maximum((raw * raw).sum(-1, keepdims=True), 1e-20)
        quad = dict(quad_q=q, quad_u=u, quad_v=v,
                    quad_n=raw / np.sqrt(len2),
                    quad_d=((raw / np.sqrt(len2)) * q).sum(-1),
                    quad_w=raw / len2)
    arrays.update(beam_tables(tri_v=host_arrays.get("tri_v"),
                              sph_c=host_arrays.get("sph_c"),
                              sph_r=host_arrays.get("sph_r"), **quad))
    return arrays, int(arrays["blk_k"][0])
