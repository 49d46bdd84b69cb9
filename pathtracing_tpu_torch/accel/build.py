"""Host-side SAH build (counterpart of pathtracing_tpu/accel/build.py).

`_sah_build_binary` is the NumPy binned-SAH builder the C++ builder
(native/bvh_builder.cpp) mirrors; it is the fallback when no C++
toolchain is available.  `sah_order` is the SAH leaf order of a set of
boxes.  `sort_key_coarse` builds coarse unions of consecutive top-level
blocks; `coarse_tables` adds the traversal kernels' coarse front over
them.  `build_bvh` collapses the binary tree into W-wide nodes for the
per-ray-stack walk (accel/traverse.py) and adds the beam backend's block
cut; `build_beam` is that block cut alone (accel/beam.py).

build_bvh's wide-node arrays (N nodes, W children each):
  bvh_lo    [N, W, 3] f32   child AABB min (empty slot: +inf)
  bvh_hi    [N, W, 3] f32   child AABB max (empty slot: -inf)
  bvh_child [N, W]    i32   >= 0: internal node id; < 0: leaf code
                            leaf code = -(prim_base * LEAF_SHIFT + count) - 1
  prim_kind [P] i32, prim_idx [P] i32: leaf order -> scene primitive
"""
from __future__ import annotations

import dataclasses

import numpy as np

W = 8            # children per node
LEAF_MAX = 4     # max primitives per leaf
LEAF_SHIFT = 8   # leaf encoding bound: SAH leaves hold < LEAF_SHIFT prims
MAX_STACK = 64   # traversal stack depth bound (checked at build time)


@dataclasses.dataclass(frozen=True)
class BVHMeta:
    n_nodes: int
    n_prims: int
    max_depth: int      # wide-tree depth, for stack sizing
    block_k: int = 0    # beam-traversal prims per block


def _leaf_code(base: int, count: int) -> int:
    assert 0 < count < LEAF_SHIFT
    return -(base * LEAF_SHIFT + count) - 1


def decode_leaf(code):
    """Leaf decode of codes (ints, arrays or tensors): (base, count)."""
    v = -(code + 1)
    return v // LEAF_SHIFT, v % LEAF_SHIFT


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


def _collapse_wide(nodes, order):
    """Collapse the binary tree into W-wide nodes: each wide node's child
    list grows by replacing its internal child of largest surface area by
    that child's two children (the reference's greedy rule), breadth
    first so parents get the lower indices.  Returns (wide_lo, wide_hi,
    wide_child, max_depth)."""

    def area(i):
        d = np.maximum(nodes[i]["hi"] - nodes[i]["lo"], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def empty():
        return (np.full((W, 3), np.inf, np.float32),
                np.full((W, 3), -np.inf, np.float32), np.zeros(W, np.int64))

    wide = [empty()]
    wide_index = {0: 0}
    queue = [0]
    depth_of = {0: 1}
    max_depth = 1
    qi = 0
    while qi < len(queue):
        bi = queue[qi]
        qi += 1
        children = [bi] if nodes[bi]["left"] < 0 else \
            [nodes[bi]["left"], nodes[bi]["right"]]
        while len(children) < W:
            cand = [(area(c), j) for j, c in enumerate(children)
                    if nodes[c]["left"] >= 0]
            if not cand:
                break
            _, j = max(cand)
            c = children.pop(j)
            children.extend([nodes[c]["left"], nodes[c]["right"]])
        clo, chi, cidx = empty()
        for j, c in enumerate(children):
            clo[j] = nodes[c]["lo"]
            chi[j] = nodes[c]["hi"]
            if nodes[c]["left"] < 0:
                cidx[j] = _leaf_code(nodes[c]["start"], nodes[c]["count"])
            else:
                wide_index[c] = len(wide)
                wide.append(empty())
                cidx[j] = wide_index[c]
                queue.append(c)
                depth_of[c] = depth_of[bi] + 1
                max_depth = max(max_depth, depth_of[c])
        wide[wide_index[bi]] = (clo, chi, cidx)
    wlo, whi, wchild = (np.stack(x) for x in zip(*wide))
    return wlo, whi, wchild.astype(np.int64), max_depth


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
    of 8 consecutive boxes (sort_key_coarse, the reference's hierarchical
    sort key's), and
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


def _block_arrays(host_arrays, lo, hi, kinds, idxs, order):
    """accel/beam.py's block cut over the SAH `order` and its
    component-first geometry tables (quad plane data derived from q, u, v
    as the reference derives it)."""
    from .beam import build_blocks, beam_tables

    arrays, _ = build_blocks(lo, hi, kinds, idxs, order)
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
    return arrays


def build_bvh(host_arrays, backend: str = "auto"):
    """The scene's wide BVH: host_arrays holds tri_v / sph_c / sph_r /
    quad_q / quad_u / quad_v at their real lengths (NumPy, None when
    absent).  Returns (arrays, BVHMeta): the wide-node arrays (module
    docstring) and the beam backend's block cut over the same SAH order,
    whose padded prim tables supersede the unpadded ones (the unpadded
    prefix is unchanged, so the leaf codes stay valid).

    backend: "auto" prefers the threaded C++ builder and falls back to
    NumPy; "native" or "numpy" force one."""
    from ..native.loader import native_build_bvh

    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    pb = _prim_bounds(host_arrays)
    if pb is None:
        raise ValueError("empty scene")
    lo, hi, kinds, idxs = pb
    result = None
    if backend != "numpy":
        result = native_build_bvh(lo, hi, LEAF_MAX)
        if result is None and backend == "native":
            raise RuntimeError("native BVH builder unavailable")
    if result is not None:
        wlo, whi, wchild, order, depth = result
    else:
        nodes, order = _sah_build_binary(lo, hi, leaf_size=LEAF_MAX)
        wlo, whi, wchild, depth = _collapse_wide(nodes, order)
    assert depth * (W - 1) + 1 < MAX_STACK * (W - 1), "stack bound"
    arrays = dict(bvh_lo=wlo.astype(np.float32),
                  bvh_hi=whi.astype(np.float32),
                  bvh_child=wchild.astype(np.int32),
                  prim_kind=kinds[order].astype(np.int32),
                  prim_idx=idxs[order].astype(np.int32))
    arrays.update(_block_arrays(host_arrays, lo, hi, kinds, idxs, order))
    meta = BVHMeta(n_nodes=len(wlo), n_prims=len(order), max_depth=depth,
                   block_k=int(arrays["blk_k"][0]))
    return arrays, meta


def build_beam(host_arrays):
    """The beam backend's tables (build_bvh without its wide-node arrays,
    which only the per-ray-stack walk reads): host_arrays as build_bvh's.
    Returns (arrays, block_k): accel/beam.py's build_blocks over the SAH
    order of every primitive, and its beam_tables."""
    pb = _prim_bounds(host_arrays)
    if pb is None:
        raise ValueError("empty scene")
    lo, hi, kinds, idxs = pb
    arrays = _block_arrays(host_arrays, lo, hi, kinds, idxs,
                           sah_order(lo, hi))
    return arrays, int(arrays["blk_k"][0])
