"""Ray-scene intersection (counterpart of pathtracing_tpu/scene/intersect.py).

Four backends, chosen by meta.accel:
  "brute"  - a chunked scan over every primitive ([N, C] tensor tests),
             the correctness reference;
  "beam"   - the block-beam walk over a flat block cut of the SAH order
             (accel/beam.py; plain PyTorch), every shape kind;
  "bvh"    - the per-ray-stack walk of the wide BVH (accel/traverse.py;
             plain PyTorch), every shape kind;
  "pallas" - triangles through the traversal kernels (two-level tables:
             accel/trace2.py, single-level ones: accel/trace1.py; the CUDA
             kernel on the card, its plain version on the CPU), analytic
             prims through the brute scan, results merged.  The name is
             the reference package's; a scene built there carries across
             unchanged.

Shape kinds: 0 = triangle, 1 = sphere, 2 = quad, 3 = triangle of a
run-time instance, idx = instance * meta.n_obj_tri + object triangle
(types.py).  `time` [N] is the per-ray shutter time of a moving scene
(meta.has_motion): a primitive moving at `vel` hit at `time` is the
static primitive hit from origin - vel * time.

Every gather index is clamped into its table explicitly: the reference
relies on XLA clamping out-of-range gathers, a CUDA gather faults.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from ..core.device import resolve_device, to_device
from ..core.math import (fma, fsqrt, SHADOW_EPS, BIG_F32, vdot, vdot_k,
                         safe_normalize, sphere_uv, offset_ray, unpack3,
                         pack3, sdot, scross, sdot_f, scross_f, sbary_mix,
                         ssafe_normalize, sonb_from_normal, _inv_guard)
from ..core.rng import hash_u32, uniform_from_u32
from ..utils.profile import count, host_any, set_count, span, spanned
from .textures import texture_alpha, texture_eval
from .types import (SHAPE_TRI, SHAPE_SPH, SHAPE_QUAD, SHAPE_ITRI,
                    ALPHA_BLEND, ALPHA_MASK)

_CHUNK = 512


def _rows(idx, table):
    return torch.clamp(idx, 0, table.shape[0] - 1)


# ---------------------------------------------------------------------------
# Per-shape batched tests: rays [N,3] x prims [C,...] -> [N,C]
# ---------------------------------------------------------------------------

def _ray_origin_comps(o, vel, time):
    """Per-(ray, prim) effective origin components [N, C or 1]: o - vel *
    time for prims moving at vel [C,3] (o itself when static)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    if vel is None or time is None:
        return ox, oy, oz
    tt = time[:, None]
    return (ox - vel[None, :, 0] * tt, oy - vel[None, :, 1] * tt,
            oz - vel[None, :, 2] * tt)


def _tri_hits(o, d, v0, v1, v2, t_min=SHADOW_EPS, vel=None, time=None):
    """Two-sided Moller-Trumbore.  Returns (t, valid)."""
    e1 = v1 - v0
    e2 = v2 - v0
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    near_zero = torch.abs(det) < 1e-9
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    ox, oy, oz = _ray_origin_comps(o, vel, time)
    sx = ox - v0[None, :, 0]
    sy = oy - v0[None, :, 1]
    sz = oz - v0[None, :, 2]
    u = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (~near_zero & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
             & (t >= t_min))
    return torch.where(valid, t, BIG_F32), valid


def _sph_hits(o, d, c, r, t_min=SHADOW_EPS, vel=None, time=None):
    """Quadratic sphere test, both roots."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = _ray_origin_comps(o, vel, time)
    ocx = ox - c[None, :, 0]
    ocy = oy - c[None, :, 1]
    ocz = oz - c[None, :, 2]
    # sums of products rounded as the reference's fused multiply-adds
    a = fma(dz, dz, fma(dx, dx, dy * dy))
    b = fma(ocz, dz, fma(ocx, dx, ocy * dy))
    cc = fma(ocz, ocz, fma(ocx, ocx, ocy * ocy)) - (r * r)[None]
    disc = fma(b, b, -(a * cc))
    ok = disc > 0
    sq = fsqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t0v = ok & (t0 > t_min)
    t1v = ok & (t1 > t_min)
    t = torch.where(t0v, t0, torch.where(t1v, t1, BIG_F32))
    return t, t0v | t1v


def _quad_hits(o, d, q, n, dd, u, v, w, t_min=SHADOW_EPS, vel=None,
               time=None):
    """Two-sided parallelogram test.  Returns (t, valid, alpha, beta)."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = _ray_origin_comps(o, vel, time)
    nx, ny, nz = n[None, :, 0], n[None, :, 1], n[None, :, 2]
    # sums of products rounded as the reference's fused multiply-adds
    d_dot_n = fma(dz, nz, fma(dx, nx, dy * ny))
    flip = d_dot_n > 0
    sgn = torch.where(flip, -1.0, 1.0)
    nnx, nny, nnz = sgn * nx, sgn * ny, sgn * nz
    dd_s = sgn * dd[None]
    denom = sgn * d_dot_n
    small = torch.abs(denom) < 1e-8
    t = ((dd_s - fma(nnz, oz, fma(nnx, ox, nny * oy)))
         / torch.where(small, 1.0, denom))
    px = fma(t, dx, ox) - q[None, :, 0]
    py = fma(t, dy, oy) - q[None, :, 1]
    pz = fma(t, dz, oz) - q[None, :, 2]
    ux, uy, uz = u[None, :, 0], u[None, :, 1], u[None, :, 2]
    vx, vy, vz = v[None, :, 0], v[None, :, 1], v[None, :, 2]
    wx, wy, wz = w[None, :, 0], w[None, :, 1], w[None, :, 2]
    # alpha = w . (p x v);  beta = w . (u x p)
    alpha = fma(wz, fma(px, vy, -(py * vx)),
                fma(wx, fma(py, vz, -(pz * vy)), wy * fma(pz, vx, -(px * vz))))
    beta = fma(wz, fma(ux, py, -(uy * px)),
               fma(wx, fma(uy, pz, -(uz * py)), wy * fma(uz, px, -(ux * pz))))
    interior = (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
    valid = ~small & (t >= t_min) & interior
    return torch.where(valid, t, BIG_F32), valid, alpha, beta


# ---------------------------------------------------------------------------
# Dispatch sort key
# ---------------------------------------------------------------------------

def _slab_top2(bl, bh, origin, inv):
    """Chunked slab over box tables: per ray the two nearest entered boxes
    (entry distance + id), BIG/0 when fewer."""
    m = bl.shape[0]
    C = 512
    mp = -(-m // C) * C
    # pad with degenerate far-point boxes (never entered)
    blp = torch.nn.functional.pad(bl, (0, 0, 0, mp - m), value=3e37)
    bhp = torch.nn.functional.pad(bh, (0, 0, 0, mp - m), value=3e37)
    n = origin.shape[0]
    dev = origin.device
    lane = torch.arange(C, device=dev)[None, :]
    be = torch.full((n,), BIG_F32, device=dev)
    bi = torch.zeros((n,), dtype=torch.int64, device=dev)
    be2 = torch.full((n,), BIG_F32, device=dev)
    bi2 = torch.zeros((n,), dtype=torch.int64, device=dev)
    for c in range(mp // C):
        lo = blp[c * C:(c + 1) * C]
        hi = bhp[c * C:(c + 1) * C]
        u0 = (lo[None, :, 0] - origin[:, 0:1]) * inv[:, 0:1]
        u1 = (hi[None, :, 0] - origin[:, 0:1]) * inv[:, 0:1]
        tn = torch.minimum(u0, u1)
        tf = torch.maximum(u0, u1)
        u0 = (lo[None, :, 1] - origin[:, 1:2]) * inv[:, 1:2]
        u1 = (hi[None, :, 1] - origin[:, 1:2]) * inv[:, 1:2]
        tn = torch.maximum(tn, torch.minimum(u0, u1))
        tf = torch.minimum(tf, torch.maximum(u0, u1))
        u0 = (lo[None, :, 2] - origin[:, 2:3]) * inv[:, 2:3]
        u1 = (hi[None, :, 2] - origin[:, 2:3]) * inv[:, 2:3]
        tn = torch.clamp(torch.maximum(tn, torch.minimum(u0, u1)), min=0.0)
        tf = torch.minimum(tf, torch.maximum(u0, u1))
        e = torch.where(tn <= tf, tn, BIG_F32)              # [N,C]
        ce, ci_l = torch.min(e, dim=1)
        ci = ci_l + c * C
        # chunk-local runner-up
        e2 = torch.where(lane == ci_l[:, None], BIG_F32, e)
        ce2, ci2 = torch.min(e2, dim=1)
        ci2 = ci2 + c * C
        # merge the running top-2 with the chunk's top-2
        old1 = be <= ce
        t1e = torch.where(old1, be, ce)
        t1i = torch.where(old1, bi, ci)
        alt_e = torch.where(old1, ce, be)
        alt_i = torch.where(old1, ci, bi)
        sec_e = torch.where(old1, be2, ce2)
        sec_i = torch.where(old1, bi2, ci2)
        t2o = alt_e <= sec_e
        be2 = torch.where(t2o, alt_e, sec_e)
        bi2 = torch.where(t2o, alt_i, sec_i)
        be, bi = t1e, t1i
    return be, bi, be2, bi2


@spanned("intersect.sort_key")
def _first_block_key(scene, origin, direction):
    """Dispatch sort key: the ids of the first two L1 blocks each ray
    enters (blocks are SAH-ordered, so rays that share them share a
    traversal working set) with the direction octant as tie-break; rays
    entering nothing sort after every live ray.  Keys order work only,
    they never change results.

    On the card one launch of csrc/sortkey.cu (`sort_key_launch`), which
    equals the plain version (`_first_block_key_plain`) bit for bit; on
    the CPU the plain version.  The reference's hierarchical key
    (PT_HIER_KEY=1 there) is not read: it orders the same work and never
    won on the card."""
    if origin.is_cuda:
        return sort_key_launch(scene["pk_blk_lo"], scene["pk_blk_hi"], origin,
                               direction)
    return _first_block_key_plain(scene, origin, direction)


def _first_block_key_plain(scene, origin, direction):
    """_first_block_key in plain PyTorch (chunked [N, 512] slab passes)."""
    bl = scene["pk_blk_lo"]
    m = bl.shape[0]
    be, bi, be2, bi2 = _slab_top2(bl, scene["pk_blk_hi"], origin,
                                  _inv_guard(direction))
    octant = ((direction[:, 0] > 0).to(torch.int64)
              | ((direction[:, 1] > 0).to(torch.int64) << 1)
              | ((direction[:, 2] > 0).to(torch.int64) << 2))
    b2 = torch.where(be2 >= BIG_F32 * 0.5, bi, torch.clamp(bi2, 0, m - 1))
    if 8 * m * m < (1 << 31):
        key = (bi * m + b2) * 8 | octant
    else:                      # huge block counts: first block only
        key = (bi << 3) | octant
    return torch.where(be >= BIG_F32 * 0.5, 0x7FFFFFFE, key)


# CUDA kernel: csrc/sortkey.cu
_key_lib = None


def reset_sort_key_launches():
    """Set the kernel's launch count, the profile counter
    "sort_key.launches", to 0."""
    set_count("sort_key.launches", 0)


def build_sort_key():
    """Compile csrc/sortkey.cu (if not built yet) and load it."""
    global _key_lib
    if _key_lib is None:
        from ..accel import cubuild
        _key_lib = bind_sort_key(cubuild.load("sortkey"))
    return _key_lib


def bind_sort_key(lib):
    """Declare sortkey_launch's C signature on a loaded library (the CUDA
    build, or cubuild.host_library's host build)."""
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.sortkey_launch.restype = ctypes.c_int
    lib.sortkey_launch.argtypes = [P, P, L, P, P, L, L, L, P, P]
    return lib


def sort_key_launch(lo, hi, origin, direction, lib=None):
    """_first_block_key's flat key, one launch of csrc/sortkey.cu: lo, hi
    [m, 3] float32 box tables (contiguous), origin, direction [n, 3]
    float32 (rows at any stride).  Returns the [n] int64 key.  On the card
    it launches on the current stream, reads no device value, copies
    nothing to the device, and is counted in the profile counter
    "sort_key.launches"; lib, a cubuild.host_library build, runs it on
    CPU tensors instead (the tests; not counted)."""
    dev = torch.device("cpu") if lib is not None else origin.device
    if lib is None and dev.type != "cuda":
        raise ValueError(f"sort key kernel: rays on {dev}")
    for name, x, rows in (("lo", lo, None), ("hi", hi, lo.shape[0]),
                          ("origin", origin, None),
                          ("direction", direction, origin.shape[0])):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"sort key kernel: {name} is {x.dtype} on "
                             f"{x.device}, the call float32 on {dev}")
        if x.ndim != 2 or x.shape[1] != 3 or (rows is not None
                                              and x.shape[0] != rows):
            raise ValueError(f"sort key kernel: {name} has shape "
                             f"{tuple(x.shape)}")
        if x.stride(1) != 1 or (name in ("lo", "hi")
                                and not x.is_contiguous()):
            raise ValueError(f"sort key kernel: {name} has strides "
                             f"{x.stride()}")
    n = origin.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    stream = None if lib is not None else \
        torch.cuda.current_stream(dev).cuda_stream
    rc = (lib or build_sort_key()).sortkey_launch(
        lo.data_ptr(), hi.data_ptr(), lo.shape[0], origin.data_ptr(),
        direction.data_ptr(), n, origin.stride(0), direction.stride(0),
        out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sort key kernel launch failed (cudaError {rc})")
    if lib is None:
        count("sort_key.launches")
    return out


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------

def _subset_scene(scene, prefix):
    """View of `scene` with the prefix'd triangle table set mounted under
    the pk_ names the traversal reads (pka_* = the alpha-material split,
    builder.build_traversal_tables)."""
    if prefix == "pk_":
        return scene
    sub = {k: v for k, v in scene.items() if not k.startswith("pk")}
    for k, v in scene.items():
        if k.startswith(prefix):
            sub["pk_" + k[len(prefix):]] = v
    return sub


@spanned("intersect.dispatch")
def _pallas_dispatch(scene, meta, origin, direction, t_max,
                     any_hit: bool = False, tri_tables: str = "all",
                     analytic: bool = True, sort_key=None,
                     alpha_shadow: bool = False, time=None):
    """Triangles through the traversal kernel of their tables (two-level
    when the set has "pk_l1_base", else single-level), the analytic prims
    of a mixed scene through the brute scan, results merged.  Rays are
    sorted by _first_block_key with dead lanes (t_max <= 0) last, and
    padded to a multiple of TILE with t_max = 0 lanes.

    tri_tables: "all" traverses the main tables and then the alpha split
    (pka_*), bounded by the first result, when the scene has one;
    "opaque" / "alpha" restrict to one set (the shadow predicate's opaque
    any-hit pass and its alpha restart chain).  analytic=False leaves the
    spheres and quads out.  sort_key: precomputed _first_block_key values;
    the restart chain dispatches repeatedly from (nearly) the same origins
    and pays the slab pre-pass once (keys order work, they never change
    results).  When meta.alpha_cull_mask, the pka_* run tests the
    per-triangle alpha micro-masks in the traversal: closest passes drop
    definitely-transparent hits (amask=1; PT_AMASK_CLOSEST=0 turns this
    off); alpha_shadow=True runs the shadow walk (amask=2), whose result
    carries "solid" for lanes a definitely-opaque hit occludes outright.
    Two-level runs pass pops=meta.block_pops, and PT_WINDOW (the
    resident-window drain), read where the reference package reads it.
    The reference's multipass driver (PT_MULTIPASS there) is not read: it
    changes no result and its capped walk lost on the card.  A hit on
    a run-time instance comes back as kind SHAPE_ITRI, idx = inst *
    n_obj_tri + object triangle.  time [N]: the rays' shutter times on a
    moving scene."""
    from ..accel.trace1 import tri_intersect1
    from ..accel.trace2 import tri_intersect2, TILE

    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    motion = meta.has_motion
    if motion and time is None:
        time = torch.zeros((n,), dtype=torch.float32, device=dev)
    if sort_key is None:
        sort_key = _first_block_key(scene, origin, direction)
    key = torch.where(t_max <= 0.0, 0xFFFFFFFF, sort_key)
    perm = torch.argsort(key, stable=True)
    origin_s, direction_s, tmax_s = origin[perm], direction[perm], t_max[perm]
    pad = (-n) % TILE
    o = torch.nn.functional.pad(origin_s, (0, 0, 0, pad))
    d = torch.nn.functional.pad(direction_s, (0, 0, 0, pad), value=1.0)
    tm = torch.nn.functional.pad(tmax_s, (0, pad))    # t_max 0: pads miss
    tme = torch.nn.functional.pad(time[perm], (0, pad)) if motion else None
    am_alpha = 0
    if meta.alpha_cull_mask and not any_hit:
        if alpha_shadow:
            am_alpha = 2
        elif os.environ.get("PT_AMASK_CLOSEST", "1") != "0":
            am_alpha = 1

    def run(prefix, tmr, amask):
        sub = _subset_scene(scene, prefix)
        if "pk_l1_base" in sub:
            wdw = os.environ.get("PT_WINDOW")
            return tri_intersect2(sub, o, d, tmr, any_hit=any_hit,
                                  amask=amask, time=tme,
                                  pops=meta.block_pops,
                                  window=int(wdw) if wdw else None)
        return tri_intersect1(sub, o, d, tmr, any_hit=any_hit, amask=amask,
                              time=tme)

    runs = []
    if tri_tables in ("all", "opaque"):
        runs.append(("pk_", 0))
    if tri_tables in ("all", "alpha") and meta.alpha_block_k \
            and "pka_tri" in scene:
        runs.append(("pka_", am_alpha))
    hit = run(runs[0][0], tm, runs[0][1])
    for tables, amk in runs[1:]:
        # the later (small) table only needs strictly closer hits, and an
        # any-hit pass needs nothing once occluded
        tm2 = torch.where(hit["valid"], 0.0 if any_hit else hit["t"], tm)
        h2 = run(tables, tm2, amk)
        closer = h2["valid"] & (~hit["valid"] | (h2["t"] < hit["t"]))
        merged = dict(t=torch.where(closer, h2["t"], hit["t"]),
                      tri=torch.where(closer, h2["tri"], hit["tri"]),
                      inst=torch.where(closer, h2["inst"], hit["inst"]),
                      valid=hit["valid"] | h2["valid"])
        if "solid" in h2:
            merged["solid"] = h2["solid"] | hit.get("solid", False)
        hit = merged
    # back to the caller's ray order

    def unsort(x):
        return torch.empty_like(x[:n]).index_copy_(0, perm, x[:n])

    t, idx, valid = unsort(hit["t"]), unsort(hit["tri"]), unsort(hit["valid"])
    solid = unsort(hit["solid"]) if "solid" in hit else None
    kind = torch.where(valid, SHAPE_TRI, -1)
    if meta.n_inst:
        inst = unsort(hit["inst"])
        is_i = valid & (inst >= 0)
        idx = torch.where(is_i, inst * meta.n_obj_tri + idx, idx)
        kind = torch.where(is_i, SHAPE_ITRI, kind)

    if analytic and (meta.n_sph or meta.n_quad):
        meta2 = dataclasses.replace(meta, n_tri=0, accel="brute", n_inst=0,
                                    n_obj_tri=0)
        other = _intersect(scene, meta2, origin, direction, t_max, time)
        better = other["valid"] & (~valid | (other["t"] < t))
        t = torch.where(better, other["t"], t)
        kind = torch.where(better, other["kind"], kind)
        idx = torch.where(better, other["idx"], idx)
        valid = valid | other["valid"]
    out = dict(t=torch.where(valid, t, BIG_F32), kind=kind, idx=idx,
               valid=valid)
    if solid is not None:
        out["solid"] = solid
    return out


def _beam(scene, meta, origin, direction, t_max, any_hit=False):
    from ..accel.beam import beam_intersect
    return beam_intersect(scene, origin, direction, t_max, meta.block_k,
                          any_hit=any_hit,
                          shapes=(meta.n_tri > 0, meta.n_sph > 0,
                                  meta.n_quad > 0))


def _bvh(scene, meta, origin, direction, t_max, any_hit=False):
    from ..accel.traverse import bvh_intersect
    return bvh_intersect(scene, origin, direction, t_max, any_hit=any_hit,
                         shapes=(meta.n_tri > 0, meta.n_sph > 0,
                                 meta.n_quad > 0))


def _intersect(scene, meta, origin, direction, t_max, time=None):
    if meta.accel == "pallas":
        return _pallas_dispatch(scene, meta, origin, direction, t_max,
                                time=time)
    if meta.accel == "beam":      # static scenes only (the builder's rule)
        return _beam(scene, meta, origin, direction, t_max)
    if meta.accel == "bvh":       # the same
        return _bvh(scene, meta, origin, direction, t_max)
    motion = meta.has_motion and time is not None
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                device=dev), (n,)).clone()
    best_kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=dev)

    def fold(t, valid, kind, base):
        nonlocal best_t, best_kind, best_idx
        t = torch.where(valid, t, BIG_F32)
        tmin, cmin = torch.min(t, dim=1)          # first min
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, base + cmin, best_idx)

    def vel(name, c0, c1):
        return scene[name][c0:c1] if motion else None

    # chunk width: [N, C] test temporaries of ~1M elements on the CPU
    # (cache-sized), ~4M on a card
    chunk = max(_CHUNK, (1 << (22 if origin.is_cuda else 20)) // max(n, 1))
    for c0 in range(0, meta.n_tri, chunk):
        c1 = min(c0 + chunk, meta.n_tri)
        v = scene["tri_v"][c0:c1]
        t, valid = _tri_hits(origin, direction, v[:, 0], v[:, 1], v[:, 2],
                             vel=vel("tri_vel", c0, c1), time=time)
        fold(t, valid, SHAPE_TRI, c0)
    for c0 in range(0, meta.n_sph, chunk):
        c1 = min(c0 + chunk, meta.n_sph)
        t, valid = _sph_hits(origin, direction, scene["sph_c"][c0:c1],
                             scene["sph_r"][c0:c1],
                             vel=vel("sph_vel", c0, c1), time=time)
        fold(t, valid, SHAPE_SPH, c0)
    for c0 in range(0, meta.n_quad, chunk):
        c1 = min(c0 + chunk, meta.n_quad)
        t, valid, _, _ = _quad_hits(
            origin, direction, scene["quad_q"][c0:c1],
            scene["quad_n"][c0:c1], scene["quad_d"][c0:c1],
            scene["quad_u"][c0:c1], scene["quad_v"][c0:c1],
            scene["quad_w"][c0:c1], vel=vel("quad_vel", c0, c1), time=time)
        fold(t, valid, SHAPE_QUAD, c0)
    if meta.n_inst:
        # run-time instances: the ray goes to each instance's object space
        # (direction unnormalized, so t stays the world parameter) and
        # tests the model's object-space triangles there
        from ..accel.trace2 import instance_rays
        inv = scene["inst_inv"].reshape(-1, 12)
        velo = _inst_velo(scene, inv) if motion else None
        for i in range(meta.n_inst):
            ii = torch.full((n,), i, dtype=torch.int64, device=dev)
            o_l, d_l = instance_rays(inv, ii, origin, direction, velo,
                                     time if motion else None)
            count("host_syncs", 2)
            base = int(scene["inst_base"][i])
            end = min(base + int(scene["inst_count"][i]), meta.n_obj_tri)
            for c0 in range(base, end, chunk):
                v = scene["otri_v"][c0:min(c0 + chunk, end)]
                t, valid = _tri_hits(o_l, d_l, v[:, 0], v[:, 1], v[:, 2])
                fold(t, valid, SHAPE_ITRI, i * meta.n_obj_tri + c0)
    return dict(t=best_t, kind=best_kind, idx=best_idx, valid=best_kind >= 0)


def _inst_velo(scene, inv):
    """Object-space velocities [I,3] of the instances: inv_lin @ vel."""
    m = inv.reshape(-1, 3, 4)[:, :, :3]
    return (m * scene["inst_vel"][:, None, :]).sum(-1)


def intersect(scene, meta, origin, direction, t_max, time=None, device=None):
    """Closest hit for a ray batch [N]: dict(t, kind, idx, valid).  time
    [N]: shutter times on a moving scene.  Runs on the GPU unless
    device="cpu"."""
    dev = resolve_device(device)
    return _intersect(to_device(scene, dev), meta, origin.to(dev),
                      direction.to(dev),
                      torch.as_tensor(t_max, dtype=torch.float32).to(dev),
                      None if time is None else time.to(dev))


# ---------------------------------------------------------------------------
# Interaction assembly (gathers at the winning primitive)
# ---------------------------------------------------------------------------

def _tri_barycentrics(origin, direction, tv):
    """(bu, bv, bw, e1, e2) of the hit of each ray on its triangle tv
    [N,3,3], recomputed at the hit (cheaper than storing them).

    The sums of products are rounded as fused multiply-adds, in the order
    the reference package's compiled CPU code contracts them: texture
    coordinates interpolated from these barycentrics are multiplied by the
    texture's width, so at uv ~ 8 on a 512-texel map a one-ulp difference
    moves a bilinear weight by 5e-4 and a normal-mapped shading normal
    with it."""
    dxr, dyr, dzr = unpack3(direction)
    e1 = (tv[:, 1, 0] - tv[:, 0, 0], tv[:, 1, 1] - tv[:, 0, 1],
          tv[:, 1, 2] - tv[:, 0, 2])
    e2 = (tv[:, 2, 0] - tv[:, 0, 0], tv[:, 2, 1] - tv[:, 0, 1],
          tv[:, 2, 2] - tv[:, 0, 2])
    h = scross_f(dxr, dyr, dzr, *e2)
    det = sdot_f(*e1, *h)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    s = (origin[:, 0] - tv[:, 0, 0], origin[:, 1] - tv[:, 0, 1],
         origin[:, 2] - tv[:, 0, 2])
    bu = sdot_f(*s, *h) * inv_det
    q = scross_f(*s, *e1)
    bv = sdot_f(dxr, dyr, dzr, *q) * inv_det
    return bu, bv, 1.0 - bu - bv, e1, e2


def _ref_tangent(ns):
    """normalize(cross(up, ns)), up = (0,1,0) when |ns.x| > 0.9999."""
    big_x = torch.abs(ns[..., 0:1]) > 0.9999
    count("host_syncs", 2)      # two copies to the device the host waits for
    up = torch.where(big_x, ns.new_tensor([0.0, 1.0, 0.0]),
                     ns.new_tensor([1.0, 0.0, 0.0]))
    return safe_normalize(torch.cross(up.expand_as(ns), ns, dim=-1))


def _instance_triangles(scene, meta, idx, time=None):
    """World-space vertices [N,3,3] of the instanced-triangle hits idx
    (= inst * n_obj_tri + object triangle), at the rays' times when the
    scene moves, with the clamped (instance, object triangle) ids."""
    iid = torch.clamp(idx // meta.n_obj_tri, 0, scene["inst_fwd"].shape[0] - 1)
    oid = torch.clamp(idx % meta.n_obj_tri, 0, scene["otri_v"].shape[0] - 1)
    fwd = scene["inst_fwd"][iid]                             # [N,3,4]
    ov = scene["otri_v"][oid]                                # [N,3,3]
    ov_w = torch.einsum("nij,nkj->nki", fwd[:, :, :3], ov) + fwd[:, None, :, 3]
    if time is not None:
        # a moving instance only translates: normals are unchanged
        ov_w = ov_w + (scene["inst_vel"][iid] * time[:, None])[:, None, :]
    return ov_w, iid, oid


def make_interaction(scene, meta, origin, direction, hit, time=None,
                     lite: bool = False):
    """Surface interaction for a hit batch: dict(valid, t, p_raw, p, n, ns,
    tangent, uv, mat_id, light_id, med_id, kind, idx).

      triangle: barycentric interpolation of the shading normal (flipped to
                the geometric side), integer-ulp offset origin, authored
                tangent made orthogonal to it (Gram-Schmidt) or the ONB
                tangent, normal mapping;
      sphere:   outward normal, sphere uv;
      quad:     two-sided normal, planar uv.
    Miss lanes are sanitized (p = 0, n = ns = +z, ids -1).

    lite=True skips authored-tangent interpolation and normal mapping (the
    ONB tangent is still produced): the alpha restart chain consumes only
    p_raw / n / uv / mat_id, none of which depend on either.  time [N]:
    moving primitives are taken at the ray's shutter time."""
    t = hit["t"]
    idx = hit["idx"]
    kind = hit["kind"]
    p_raw = fma(t[:, None], direction, origin)   # rounded as a fused mul-add
    motion = meta.has_motion and time is not None
    want_tan = meta.has_tangents and not lite

    # --- triangle (one packed row gather: verts 9, normals 9, uvs 6, prop 4)
    pk_row = scene["tri_pack"][_rows(idx, scene["tri_pack"])]
    tv = pk_row[:, 0:9].reshape(-1, 3, 3)
    tn = pk_row[:, 9:18].reshape(-1, 3, 3)
    tuv = pk_row[:, 18:24].reshape(-1, 3, 2)
    tprop = pk_row[:, 24:28].to(torch.int64)
    ttan = scene["tri_tan"][_rows(idx, scene["tri_tan"])] if want_tan \
        else None
    if motion:
        tvel = scene["tri_vel"][_rows(idx, scene["tri_vel"])]
        tv = tv + (tvel * time[:, None])[:, None, :]
    if meta.n_inst:
        # instanced-triangle hits: gather the object-space data, take it
        # to world space, then run the triangle math (kind folds to TRI)
        is_itri = kind == SHAPE_ITRI
        ov_w, iid, oid = _instance_triangles(scene, meta, idx,
                                             time if motion else None)
        on_w = safe_normalize(torch.einsum("nij,nkj->nki",
                                           scene["inst_nrm"][iid],
                                           scene["otri_n"][oid]))
        m3 = is_itri[:, None, None]
        tv = torch.where(m3, ov_w, tv)
        tn = torch.where(m3, on_w, tn)
        tuv = torch.where(m3, scene["otri_uv"][oid], tuv)
        if want_tan:
            otan_w = torch.einsum("nij,nkj->nki",
                                  scene["inst_fwd"][iid][:, :, :3],
                                  scene["otri_tan"][oid])
            ttan = torch.where(m3, otan_w, ttan)
        tprop = torch.where(is_itri[:, None],
                            scene["otri_prop"][oid].to(torch.int64), tprop)
        # per-instance area lights
        lbase = scene["inst_slot_base"][iid].to(torch.int64)
        lslot = lbase + (oid - scene["inst_base"][iid].to(torch.int64))
        ilight = torch.where(
            (lbase >= 0) & is_itri,
            scene["ilight_map"][_rows(lslot, scene["ilight_map"])]
            .to(torch.int64), -1)
        tprop = torch.cat([tprop[:, 0:1],
                           torch.where(is_itri, ilight, tprop[:, 1])[:, None],
                           tprop[:, 2:]], 1)
        kind = torch.where(is_itri, SHAPE_TRI, kind)
    dxr, dyr, dzr = unpack3(direction)
    bu, bv, bw, (e1x, e1y, e1z), (e2x, e2y, e2z) = _tri_barycentrics(
        origin, direction, tv)
    tri_uv = sbary_mix(bu[:, None], bv[:, None], bw[:, None], tuv[:, 0],
                       tuv[:, 1], tuv[:, 2])
    nsx, nsy, nsz = ssafe_normalize(
        *(sbary_mix(bu, bv, bw, tn[:, 0, c], tn[:, 1, c], tn[:, 2, c])
          for c in range(3)))
    ngx, ngy, ngz = ssafe_normalize(*scross(e1x, e1y, e1z, e2x, e2y, e2z))
    flip_ns = sdot(ngx, ngy, ngz, nsx, nsy, nsz) < 0
    nsx = torch.where(flip_ns, -nsx, nsx)
    nsy = torch.where(flip_ns, -nsy, nsy)
    nsz = torch.where(flip_ns, -nsz, nsz)
    _, (fbx, fby, fbz) = sonb_from_normal(nsx, nsy, nsz)
    if want_tan:
        trx = bu * ttan[:, 1, 0] + bv * ttan[:, 2, 0] + bw * ttan[:, 0, 0]
        try_ = bu * ttan[:, 1, 1] + bv * ttan[:, 2, 1] + bw * ttan[:, 0, 1]
        trz = bu * ttan[:, 1, 2] + bv * ttan[:, 2, 2] + bw * ttan[:, 0, 2]
        has_tan = tprop[:, 3] > 0
        ns_dot_tr = sdot(nsx, nsy, nsz, trx, try_, trz)
        tgx, tgy, tgz = ssafe_normalize(trx - nsx * ns_dot_tr,
                                        try_ - nsy * ns_dot_tr,
                                        trz - nsz * ns_dot_tr)
        tan_t = pack3(torch.where(has_tan, tgx, fbx),
                      torch.where(has_tan, tgy, fby),
                      torch.where(has_tan, tgz, fbz))
    else:   # no triangle in the scene has authored tangents
        tan_t = pack3(fbx, fby, fbz)
    ns_t = pack3(nsx, nsy, nsz)
    ng_t = pack3(ngx, ngy, ngz)
    off_sign = torch.where(sdot(dxr, dyr, dzr, ngx, ngy, ngz) > 0,
                           -1.0, 1.0)[:, None]
    p_t = offset_ray(p_raw, ng_t * off_sign)

    # --- sphere
    si = _rows(idx, scene["sph_c"])
    sc = scene["sph_c"][si]
    if motion:
        sc = sc + scene["sph_vel"][si] * time[:, None]
    sprop = scene["sph_prop"][si].to(torch.int64)
    ns_s = safe_normalize(p_raw - sc)
    p_s = offset_ray(p_raw, ns_s)
    uv_s = sphere_uv(ns_s)
    tan_s = _ref_tangent(ns_s)

    # --- quad
    qi = _rows(idx, scene["quad_q"])
    qq_p = scene["quad_q"][qi]
    if motion:
        qq_p = qq_p + scene["quad_vel"][qi] * time[:, None]
    qn = scene["quad_n"][qi]
    qprop = scene["quad_prop"][qi].to(torch.int64)
    flip_q = vdot_k(direction, qn) > 0
    ns_q = torch.where(flip_q, -qn, qn)
    planar = p_raw - qq_p
    alpha = vdot(scene["quad_w"][qi],
                 torch.cross(planar, scene["quad_v"][qi], dim=-1))
    beta = vdot(scene["quad_w"][qi],
                torch.cross(scene["quad_u"][qi], planar, dim=-1))
    uv_q = torch.stack([alpha, beta], -1)
    tan_q = _ref_tangent(ns_q)
    p_q = offset_ray(p_raw, ns_q)

    is_t = (kind == SHAPE_TRI)[:, None]
    is_s = (kind == SHAPE_SPH)[:, None]

    def pick(a_t, a_s, a_q):
        return torch.where(is_t, a_t, torch.where(is_s, a_s, a_q))

    def pick_id(col):
        return torch.where(kind == SHAPE_TRI, tprop[:, col],
                           torch.where(kind == SHAPE_SPH, sprop[:, col],
                                       qprop[:, col]))

    ok = hit["valid"]
    okn = ok[:, None]
    ns = pick(ns_t, ns_s, ns_q)
    tangent = pick(tan_t, tan_s, tan_q)
    uv = pick(tri_uv, uv_s, uv_q)
    mat_id = pick_id(0)
    # normal mapping, where the material has a normal texture
    if meta.n_mat and meta.has_normal_maps and not lite:
        norm_tex = scene["mat_tex"][_rows(mat_id, scene["mat_tex"]), 3]
        has_norm = (norm_tex >= 0) & (mat_id >= 0) & ok
        nmap = texture_eval(scene, norm_tex, uv)
        n_local = safe_normalize(2.0 * nmap - 1.0)
        # local frame: axis 0 the tangent, 1 cross(ns, tangent), 2 ns
        bitan = torch.cross(ns, tangent, dim=-1)
        ns_mapped = safe_normalize(n_local[:, 0:1] * tangent
                                   + n_local[:, 1:2] * bitan
                                   + n_local[:, 2:3] * ns)
        ns = torch.where(has_norm[:, None], ns_mapped, ns)
    count("host_syncs", 2)      # two copies to the device the host waits for
    up = p_raw.new_tensor([0.0, 0.0, 1.0]).expand_as(p_raw)
    right = p_raw.new_tensor([1.0, 0.0, 0.0]).expand_as(p_raw)
    # miss lanes: with t = BIG_F32 the hit point overflows; sanitize them
    it = dict(
        valid=ok, t=t, kind=kind, idx=hit["idx"],
        p_raw=torch.where(okn, p_raw, 0.0),
        p=torch.where(okn, pick(p_t, p_s, p_q), 0.0),
        n=torch.where(okn, pick(ng_t, ns_s, qn), up),
        ns=torch.where(okn, ns, up),
        tangent=torch.where(okn, tangent, right),
        uv=torch.where(okn, uv, 0.0),
        mat_id=torch.where(ok, mat_id, -1),
        light_id=torch.where(ok, pick_id(1), -1),
        med_id=torch.where(ok, pick_id(2), -1))
    # geometry is detached from autograd: gradients reach material,
    # texture, light and medium parameters (the detached-sampling
    # estimator); geometric derivatives need estimators of their own
    return {k: v.detach() for k, v in it.items()}


def _chain_interaction(scene, meta, origin, direction, hit):
    """Triangle-only interaction subset for the alpha restart chain:
    p_raw, geometric normal, uv, mat_id and nothing else (the chain only
    advances past the surface and fetches its alpha).  Only legal when the
    chain excludes analytic prims (meta.analytic_alpha False)."""
    t = hit["t"]
    ok = hit["valid"]
    p_raw = fma(t[:, None], direction, origin)
    row = scene["tri_pack"][_rows(hit["idx"], scene["tri_pack"])]
    tv = row[:, 0:9].reshape(-1, 3, 3)
    tuv = row[:, 18:24].reshape(-1, 3, 2)
    mat = row[:, 24].to(torch.int64)
    if meta.n_inst:
        # instanced hits: object-space uv, world-space vertices
        is_i = hit["kind"] == SHAPE_ITRI
        ov_w, _, oid = _instance_triangles(scene, meta, hit["idx"])
        m3 = is_i[:, None, None]
        tv = torch.where(m3, ov_w, tv)
        tuv = torch.where(m3, scene["otri_uv"][oid], tuv)
        mat = torch.where(is_i, scene["otri_prop"][oid][:, 0].to(torch.int64),
                          mat)
    bu, bv, bw, (e1x, e1y, e1z), (e2x, e2y, e2z) = _tri_barycentrics(
        origin, direction, tv)
    uv = sbary_mix(bu[:, None], bv[:, None], bw[:, None], tuv[:, 0],
                   tuv[:, 1], tuv[:, 2])
    ngx, ngy, ngz = ssafe_normalize(*scross(e1x, e1y, e1z, e2x, e2y, e2z))
    okn = ok[:, None]
    count("host_syncs")         # a copy to the device the host waits for
    return dict(
        valid=ok, t=t,
        p_raw=torch.where(okn, p_raw, 0.0),
        n=torch.where(okn, pack3(ngx, ngy, ngz),
                      p_raw.new_tensor([0.0, 0.0, 1.0])),
        uv=torch.where(okn, uv, 0.0),
        mat_id=torch.where(ok, mat, -1))


# ---------------------------------------------------------------------------
# Shadow predicate
# ---------------------------------------------------------------------------

MAX_RESTARTS = 64    # safety net against degenerate geometry, not a budget


@spanned("intersect.shadow")
def _occluded(scene, meta, origin, direction, t_max, rand_key=None,
              stats: dict | None = None, compact: bool = True, time=None):
    """The shadow predicate on device tensors (see `occluded`).  `stats`,
    when given, accumulates "calls" and "restarts" (chain iterations run).
    compact=False keeps every restart at full width (the tests hold the
    compacted tail to it)."""
    if not meta.has_alpha:
        # opaque scene: pure any-hit
        if meta.accel == "pallas":
            return _pallas_dispatch(scene, meta, origin, direction,
                                    t_max - SHADOW_EPS, any_hit=True,
                                    time=time)["valid"]
        if meta.accel == "beam":
            return _beam(scene, meta, origin, direction, t_max - SHADOW_EPS,
                         any_hit=True)["valid"]
        if meta.accel == "bvh":
            return _bvh(scene, meta, origin, direction, t_max - SHADOW_EPS,
                        any_hit=True)["valid"]
        return _intersect(scene, meta, origin, direction,
                          t_max - SHADOW_EPS, time)["valid"]

    n = origin.shape[0]
    dev = origin.device
    split = (meta.accel == "pallas" and meta.alpha_block_k > 0
             and "pka_tri" in scene)
    if split:
        # ONE slab pre-pass for the whole predicate: the opaque any-hit and
        # every restart dispatch from the same origins (restarts only
        # advance along the ray), so they share the key
        key0 = _first_block_key(scene, origin, direction)
        # analytic prims with only opaque materials never need an alpha
        # test: they fold into the single any-hit pass and drop out of
        # every chain iteration
        ana_alpha = meta.analytic_alpha
        occ0 = _pallas_dispatch(scene, meta, origin, direction,
                                t_max - SHADOW_EPS, any_hit=True,
                                tri_tables="opaque", analytic=not ana_alpha,
                                sort_key=key0, time=time)["valid"]

        def chain_isect(o, d, t_rem, key, tme):
            # with micro-masked tables each dispatch resolves definitely-
            # opaque hits in the traversal ("solid" lanes: occluded, no
            # restart) and skips definitely-transparent ones, so the chain
            # iterates only on hits that need the exact texture test
            return _pallas_dispatch(scene, meta, o, d, t_rem,
                                    tri_tables="alpha", analytic=ana_alpha,
                                    sort_key=key, alpha_shadow=True, time=tme)

        def chain_inter(h, o, d, tme):
            if not ana_alpha:
                return _chain_interaction(scene, meta, o, d, h)
            return make_interaction(scene, meta, o, d, h, time=tme,
                                    lite=True)
    else:
        # no split tables: the restart chain runs over the whole scene
        occ0 = torch.zeros((n,), dtype=torch.bool, device=dev)
        key0 = None

        def chain_isect(o, d, t_rem, key, tme):
            return _intersect(scene, meta, o, d, t_rem, tme)

        def chain_inter(h, o, d, tme):
            return make_interaction(scene, meta, o, d, h, time=tme,
                                    lite=True)

    def body(o, d, t_rem, live, lane, key, rkey, it_, tme):
        """One restart for the lanes given: (o, t_rem, newly occluded,
        live) after it.  `lane` is each lane's index in the caller's batch:
        the BLEND random number is keyed on it, so gathering the live lanes
        changes no result."""
        # finished lanes trace zero-length rays (sorted last, no work)
        h = chain_isect(o, d, torch.where(live, t_rem, 0.0), key, tme)
        # definite occlusion found in the traversal: these lanes carry no
        # candidate hit (valid False), they are done
        solid_k = h.get("solid")
        if solid_k is None:
            solid_k = torch.zeros_like(live)
        inter = chain_inter(h, o, d, tme)
        mat_ids = _rows(inter["mat_id"], scene["mat_type"])
        mode = scene["mat_alpha_mode"][mat_ids]
        cutoff = scene["mat_alpha_cutoff"][mat_ids]
        atex = scene["mat_tex"][mat_ids, 4]
        btex = scene["mat_tex"][mat_ids, 0]
        a_val = texture_alpha(scene, torch.where(atex >= 0, atex, btex),
                              inter["uv"])
        if meta.mat_tex_present[4]:
            # a dedicated alpha texture reads channel 0
            a_val = torch.where(atex >= 0,
                                texture_eval(scene, atex, inter["uv"])[:, 0],
                                a_val)
        u = uniform_from_u32(hash_u32(lane, it_,
                                      0 if rkey is None else rkey))
        solid = torch.where(mode == ALPHA_BLEND, u < a_val,
                            torch.where(mode == ALPHA_MASK, a_val > cutoff,
                                        True))
        solid = solid | (inter["mat_id"] < 0)     # no material: an occluder
        newly_occ = live & ((h["valid"] & solid) | solid_k)
        live_next = live & h["valid"] & ~solid & ~solid_k
        # scale-robust advance past the transparent surface
        n_fwd = torch.where(vdot_k(d, inter["n"]) > 0, inter["n"],
                            -inter["n"])
        o = torch.where(live_next[:, None],
                        offset_ray(inter["p_raw"], n_fwd), o)
        t_rem = torch.where(live_next, t_rem - h["t"], t_rem)
        return o, t_rem, newly_occ, live_next

    t_rem = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev) - SHADOW_EPS,
                               (n,))
    per_lane_key = isinstance(rand_key, torch.Tensor) and rand_key.ndim > 0
    o, d, key, rkey, tme = origin, direction, key0, rand_key, time
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    live = ~occ0
    occ = occ0.clone()
    it_ = 0
    # data-dependent loop: one host sync per restart (host_any, the last
    # thing in the restart's span) and one per compaction (the nonzero)
    more = it_ < MAX_RESTARTS and host_any(live)
    while more:
        with span("intersect.shadow_restart"):
            o, t_rem, newly, live = body(o, d, t_rem, live, lane, key, rkey,
                                         it_, tme)
            # lane < n always; clamped so a CUDA scatter can never fault
            occ[torch.clamp(lane, 0, n - 1)] |= newly
            it_ += 1
            if compact and lane.shape[0] > 1024:
                # tail compaction: most lanes resolve in the first
                # full-width iteration; the few survivors are gathered
                # (with their original lane index) so later restarts stop
                # paying full-width interaction and texture costs
                count("host_syncs")
                take = torch.nonzero(live)[:, 0]
                if take.shape[0] < lane.shape[0]:
                    o, d, t_rem = o[take], d[take], t_rem[take]
                    lane = lane[take]
                    key = key[take] if key is not None else None
                    rkey = rkey[take] if per_lane_key else rkey
                    tme = tme[take] if tme is not None else None
                    live = live[take]
            more = it_ < MAX_RESTARTS and host_any(live)
    if stats is not None:
        stats["calls"] = stats.get("calls", 0) + 1
        stats["restarts"] = stats.get("restarts", 0) + it_
    return occ


def occluded(scene, meta, origin, direction, t_max, rand_key=None,
             time=None, device=None):
    """Shadow predicate: is anything solid hit in [SHADOW_EPS, t_max -
    SHADOW_EPS)?

    Without alpha materials: one any-hit pass.  With alpha materials on the
    two-level tables the builder splits the alpha-material triangles into
    their own pka_* tables, so the predicate is ONE any-hit traversal of
    the opaque set plus a restart chain over only the (small) alpha set
    and, when they carry alpha materials, the analytic prims.  Each restart
    takes the nearest candidate, applies the exact test (the alpha
    texture's channel 0, else the base texture's alpha; MASK against the
    cutoff, BLEND against a random number keyed on (lane, restart,
    rand_key)) and advances past a transparent surface.  Other backends
    run the chain over the whole scene with no masks.  Runs on the GPU
    unless device="cpu"."""
    dev = resolve_device(device)
    if isinstance(rand_key, torch.Tensor):
        rand_key = rand_key.to(dev)
    return _occluded(to_device(scene, dev), meta, origin.to(dev),
                     direction.to(dev),
                     torch.as_tensor(t_max, dtype=torch.float32).to(dev),
                     rand_key, time=None if time is None else time.to(dev))
