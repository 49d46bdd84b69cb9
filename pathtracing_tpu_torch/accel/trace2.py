"""Two-level ray/triangle traversal over SAH block tables (counterpart of
pathtracing_tpu/accel/pallas_trace2.py).

Tables (build_tri_blocks2): the triangles are put in SAH order and cut
into child blocks of K2 triangles; G consecutive child blocks form one L1
superblock.  A ray visits the L1 boxes it enters nearest first, slab-tests
the G child boxes of each visited L1 and runs Moller-Trumbore only on the
K2 triangles of the children it enters.

`tri_intersect2` has the output contract of the reference package's
`pallas_tri_intersect2`: dict(t, tri, inst, valid), t = BIG_F32 and
tri = inst = -1 on a miss.  For a CUDA tensor it launches the hand-written
kernel in csrc/trace2.cu (and raises if it cannot); for a CPU tensor it
runs the plain version: Moller-Trumbore, in the kernel's arithmetic, over
every triangle of every child block whose (padded) box the ray enters,
with no ordering and no early exit.  `tri_intersect2_plain(...,
prune=False)` drops that cull and tests every slot of the table: the
oracle that holds both the kernel and the culled version to the
triangles alone.  Both take the hit with the least
t in [SHADOW_EPS, t_max) and break exact ties in t by the least table
slot, so with the kernel built without FMA contraction the two agree bit
for bit except where the kernel's box tests round a grazing hit away.
In any-hit mode `valid` is the occlusion predicate and `tri` is some
occluder: the kernel stops at the first hit it finds, the plain version
reports the nearest.

Alpha micro-mask modes (tables built with tri_mask; scene/alphamask.py):
every Moller-Trumbore hit looks up its triangle's 8x8 tri-state cell at
the hit's barycentrics.
  amask=1  closest hit in which a definitely-transparent hit is a miss;
  amask=2  the shadow walk.  With t_opq the nearest hit on a definitely-
           opaque cell and (t_mix, slot) the nearest hit on a mixed cell
           (ties to the least slot), both in [SHADOW_EPS, t_max):
             t_opq < t_mix  ->  `solid`: occluded outright, no candidate
                                (valid False, tri -1, t BIG_F32);
             else a mixed hit ->  that hit is the candidate (valid);
             else             ->  a miss.
           Transparent hits are skipped.  The result does not depend on
           visit order, so kernel and plain version agree exactly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..core.math import BIG_F32, SHADOW_EPS

G_DEFAULT = 16      # child blocks per L1 superblock
TILE = 128          # dispatch pads ray batches to a multiple of this

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "trace2.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]
_lock = threading.Lock()
_lib = None
BUILD_LOG = ""       # nvcc's output of the last build (registers, spills)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def build_tri_blocks2(tri_v: np.ndarray, k2: int | None = None,
                      g: int = G_DEFAULT, tri_mask: np.ndarray | None = None):
    """Two-level block tables for a static world triangle set.  Returns
    (arrays, k2) with numpy arrays:
      pk_tri      [M2*K2, 12] f32  per slot: v0 xyz, e1 xyz, e2 xyz, 0 0 0
                                    (three 16-byte loads per triangle);
                                    padded slots are zero rows (det == 0,
                                    never hit)
      pk_l2box    [M2, 8] f32      child boxes lo xyz 0 hi xyz 0; padded
                                    children are far-point boxes
                                    (lo == hi == 3e37, never entered)
      pk_blk_lo/hi [M1, 3] f32     L1 bounds (data children only)
      pk_l1box    [M1, 8] f32      the same, packed for the kernel
      pk_l1_base  [M1] i32         first child block of each L1
      pk_slot2tri [M2*K2] i32      slot -> triangle id, -1 on padding
      pk_sblk_lo/hi                coarse unions of 8 L1s
      pk_mask     [M2*K2, 8] i32   only with tri_mask ([T, 7] int32 alpha
                                    micro-mask words per triangle): the 7
                                    words + 1 pad per slot (two 16-byte
                                    loads), zero on padded slots
    The SAH order, the block cut and the L1 grouping are those of the
    reference package's build_tri_blocks2 (same builder, same triangles
    => same tables)."""
    from .build import _sah_build_binary, sort_key_coarse
    from ..native.loader import native_build_bvh

    tri_v = np.asarray(tri_v, np.float32)
    lo = tri_v.min(1)
    hi = tri_v.max(1)
    native = native_build_bvh(lo, hi, 4)
    if native is not None:
        order = native[3]
    else:
        _, order = _sah_build_binary(lo, hi, leaf_size=4)
    n = len(order)
    G = g
    if k2 is None:
        k2 = 128
        while -(-n // (k2 * G)) > 4096:
            k2 += 128
    m2 = -(-n // k2)
    nb_data = m2
    m2 = -(-m2 // G) * G            # whole number of G-groups
    pad = m2 * k2 - n
    ord_pad = np.concatenate([order, np.repeat(order[-1:], pad)])
    v = tri_v[ord_pad]
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    tri = np.zeros((m2 * k2, 12), np.float32)
    tri[:, 0:3] = v0
    tri[:, 3:6] = e1
    tri[:, 6:9] = e2
    if pad:
        tri[n:] = 0.0
    l2lo = lo[ord_pad].reshape(m2, k2, 3).min(1)
    l2hi = hi[ord_pad].reshape(m2, k2, 3).max(1)
    if m2 > nb_data:
        l2lo[nb_data:] = 3e37       # degenerate far-point empty boxes
        l2hi[nb_data:] = 3e37
    l2box = np.zeros((m2, 8), np.float32)
    l2box[:, 0:3] = l2lo
    l2box[:, 4:7] = l2hi

    groups = [(b, min(b + G, m2)) for b in range(0, m2, G)]
    m1 = len(groups)
    l1_base = np.asarray([b for b, _ in groups], np.int32)
    l1lo = np.empty((m1, 3), np.float32)
    l1hi = np.empty((m1, 3), np.float32)
    for i, (b, e) in enumerate(groups):
        # L1 bounds span only data blocks (a far-point padded block would
        # blow the box up to 3e37)
        wd = max(1, min(e, nb_data) - b)
        l1lo[i] = l2lo[b:b + wd].min(0)
        l1hi[i] = l2hi[b:b + wd].max(0)
    l1box = np.zeros((m1, 8), np.float32)
    l1box[:, 0:3] = l1lo
    l1box[:, 4:7] = l1hi
    slot2tri = ord_pad.astype(np.int32)
    if pad:
        slot2tri[n:] = -1
    out = dict(pk_tri=tri, pk_l2box=l2box, pk_blk_lo=l1lo, pk_blk_hi=l1hi,
               pk_l1box=l1box, pk_l1_base=l1_base, pk_slot2tri=slot2tri,
               **sort_key_coarse(l1lo, l1hi))
    if tri_mask is not None:
        tri_mask = np.asarray(tri_mask)
        if tri_mask.dtype != np.int32 or tri_mask.shape != (len(tri_v), 7):
            raise ValueError("tri_mask must be int32 [T, 7] mask words")
        mask = np.zeros((m2 * k2, 8), np.int32)
        mask[:n, :7] = tri_mask[order]
        out["pk_mask"] = mask
    return out, k2


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _moller_trumbore(o, d, tri, t_max):
    """(t, ok, u, v) of each (ray, slot) pair, t = BIG_F32 on a miss: o, d
    [P, 3], tri [P, K, 12] table rows, t_max [P]; the kernel's
    arithmetic.  u, v are the barycentrics (garbage where not ok)."""
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[..., :9].unbind(-1)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    near0 = torch.abs(det) < 1e-9
    inv_det = 1.0 / torch.where(near0, 1.0, det)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = (sx * hx + sy * hy + sz * hz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (~near0 & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
          & (t >= SHADOW_EPS) & (t < t_max[:, None]))
    return torch.where(ok, t, BIG_F32), ok, u, v


def _alpha_cell_bits(mask, u, v):
    """(opaque, mixed) bits of each hit's alpha-mask cell: mask [P, K, 8]
    int32 words (scene/alphamask.py), u, v [P, K] barycentrics; the
    kernel's arithmetic on integer tensors."""
    w = mask.to(torch.int64) & 0xFFFFFFFF
    b = [_bits_to_f32((w[..., i] << 16) & 0xFFFFFFFF) for i in range(3)]
    c = [_bits_to_f32(w[..., i] & 0xFFFF0000) for i in range(3)]
    gx = b[0] + b[1] * u + b[2] * v
    gy = c[0] + c[1] * u + c[2] * v
    cu = torch.clamp(torch.floor(gx), 0.0, 7.0).to(torch.int64)
    cv = torch.clamp(torch.floor(gy), 0.0, 7.0).to(torch.int64)
    cell = cv * 8 + cu
    sh = cell & 31
    lo_half = cell < 32
    opq = (torch.where(lo_half, w[..., 3], w[..., 4]) >> sh) & 1
    mix = (torch.where(lo_half, w[..., 5], w[..., 6]) >> sh) & 1
    return opq > 0, mix > 0


def _bits_to_f32(bits):
    """int64 tensor holding uint32 bit patterns -> the float32 they spell."""
    signed = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def _entered_children(scene, o, d, t_max):
    """(ray, child) pairs whose child box, padded by 1e-4 of its size and
    magnitude, the ray enters below t_max.  The padding is far above the
    rounding of a hit point, so no child that holds a hit is dropped."""
    box = scene["pk_l2box"]
    lo, hi = box[:, 0:3], box[:, 4:7]
    pad = 1e-4 * (hi - lo + torch.maximum(lo.abs(), hi.abs()))
    lo, hi = lo - pad, hi + pad
    tiny = torch.where(d < 0, -1e-32, 1e-32)
    inv = 1.0 / torch.where(d.abs() < 1e-32, tiny, d)
    a = (lo[None] - o[:, None]) * inv[:, None]          # [R, M2, 3]
    b = (hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(a, b).amax(-1).clamp(min=0.0)
    tf = torch.maximum(a, b).amin(-1).clamp(max=t_max[:, None])
    return torch.nonzero(tn <= tf).unbind(1)


def _plain_slots(scene, origin, direction, t_max, prune=True, amask=0):
    """Nearest (t, slot) per ray, by Moller-Trumbore over every triangle of
    every child block the ray enters (every child block when prune is
    False); no ordering, no early exit; ties in t go to the least slot.
    amask 1 / 2: the alpha micro-mask modes of the module docstring; a
    `solid` lane of mode 2 is reported as slot -2."""
    tri = scene["pk_tri"]
    m2 = scene["pk_l2box"].shape[0]
    k2 = tri.shape[0] // m2
    tri = tri.view(m2, k2, 12)
    mask = scene["pk_mask"].view(m2, k2, 8) if amask else None
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), BIG_F32, dtype=torch.float32, device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    t_opq = torch.full((n,), BIG_F32, dtype=torch.float32, device=dev)
    # temporaries of ~2^20 (CPU) / 2^26 (card) elements per chunk
    budget = 1 << (26 if origin.is_cuda else 20)
    rchunk = max(1, budget // max(1, m2))
    pchunk = max(1, budget // (8 * k2))
    for r0 in range(0, n, rchunk):
        if prune:
            ray, child = _entered_children(scene, origin[r0:r0 + rchunk],
                                           direction[r0:r0 + rchunk],
                                           t_max[r0:r0 + rchunk])
        else:
            nr = min(rchunk, n - r0)
            ray = torch.arange(nr, device=dev).repeat_interleave(m2)
            child = torch.arange(m2, device=dev).repeat(nr)
        ray = ray + r0
        for p0 in range(0, ray.shape[0], pchunk):
            r, c = ray[p0:p0 + pchunk], child[p0:p0 + pchunk]
            t, ok, u, v = _moller_trumbore(origin[r], direction[r], tri[c],
                                           t_max[r])
            if amask:
                opq, mix = _alpha_cell_bits(mask[c], u, v)
                if amask == 1:
                    t = torch.where(ok & (opq | mix), t, BIG_F32)
                else:
                    t_opq = t_opq.scatter_reduce(
                        0, r, torch.where(ok & opq, t, BIG_F32).amin(1),
                        "amin")
                    t = torch.where(ok & mix, t, BIG_F32)
            pt, pk = torch.min(t, dim=1)     # first min: least slot
            ps = c * k2 + pk
            new_t = best_t.scatter_reduce(0, r, pt, "amin")
            cand = torch.where((pt == new_t[r]) & (pt < BIG_F32), ps,
                               torch.iinfo(torch.int64).max)
            keep = torch.where(new_t == best_t, best_s,
                               torch.iinfo(torch.int64).max)
            best_s = keep.scatter_reduce(0, r, cand, "amin")
            best_t = new_t
    best_s = torch.where(best_t < BIG_F32, best_s, -1)
    if amask == 2:
        solid = t_opq < best_t
        best_t = torch.where(solid, BIG_F32, best_t)
        best_s = torch.where(solid, -2, best_s)
    return best_t, best_s


# ---------------------------------------------------------------------------
# CUDA kernel: build + launch
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the trace2 CUDA kernel cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def build_kernel() -> float:
    """Compile csrc/trace2.cu (if not built yet) and load it.  Returns the
    seconds spent.  The library is cached in _build/ by content hash."""
    global _lib, BUILD_LOG
    t0 = time.perf_counter()
    with _lock:
        if _lib is not None:
            return 0.0
        src = _CSRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _BUILD_DIR / f"trace2_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                                  str(_CSRC)], capture_output=True, text=True)
            BUILD_LOG = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError("nvcc failed on trace2.cu:\n" + BUILD_LOG)
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.trace2_launch.restype = I
        lib.trace2_launch.argtypes = [P, P, P, I, P, I, P, P, P, P, I, I, I,
                                      I, P, P, P, P, P]
        _lib = lib
    return time.perf_counter() - t0


def _check(name, x, dtype, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"trace2: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {x.dtype} on {x.device}")


def _mode_name(any_hit, amask):
    return "any_hit" if any_hit else ("closest", "amask1", "amask2")[amask]


def _launch_kernel(scene, origin, direction, t_max, any_hit, counters,
                   amask):
    build_kernel()
    dev = origin.device
    n = origin.shape[0]
    tri, l2box = scene["pk_tri"], scene["pk_l2box"]
    l1box, l1_base = scene["pk_l1box"], scene["pk_l1_base"]
    for name, x, dt in (("origin", origin, torch.float32),
                        ("direction", direction, torch.float32),
                        ("t_max", t_max, torch.float32),
                        ("pk_tri", tri, torch.float32),
                        ("pk_l2box", l2box, torch.float32),
                        ("pk_l1box", l1box, torch.float32),
                        ("pk_l1_base", l1_base, torch.int32)):
        _check(name, x, dt, dev)
    mask = None
    if amask:
        mask = scene["pk_mask"]
        _check("pk_mask", mask, torch.int32, dev)
        if mask.shape != (tri.shape[0], 8):
            raise ValueError("trace2: pk_mask must hold 8 words per slot")
    m1, m2 = l1box.shape[0], l2box.shape[0]
    if (origin.shape != (n, 3) or direction.shape != (n, 3)
            or tri.shape[1:] != (12,) or l2box.shape[1:] != (8,)
            or l1box.shape[1:] != (8,) or l1_base.shape != (m1,)
            or m2 % m1 or tri.shape[0] % m2):
        raise ValueError("trace2: ray or table shapes do not match the "
                         "build_tri_blocks2 layout")
    k2 = tri.shape[0] // m2
    g = m2 // m1
    if g > 64:
        raise ValueError(f"trace2: at most 64 child blocks per L1, got {g}")
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = touched = None
    if counters:
        cnt = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        touched = torch.zeros((m1 + m2,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.trace2_launch(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), n,
        l1box.data_ptr(), m1, l1_base.data_ptr(),
        l2box.data_ptr(), tri.data_ptr(),
        mask.data_ptr() if amask else None, k2, g, int(bool(any_hit)),
        int(amask), out_t.data_ptr(), out_slot.data_ptr(),
        cnt.data_ptr() if counters else None,
        touched.data_ptr() if counters else None, stream)
    if rc != 0:
        raise RuntimeError(f"trace2 kernel launch failed (cudaError {rc})")
    tri_intersect2.launches += 1
    tri_intersect2.launches_by_mode[_mode_name(any_hit, amask)] += 1
    if counters:
        cnt = dict(counters=cnt, l1_touched=touched[:m1].bool(),
                   leaf_touched=touched[m1:].bool())
    return out_t, out_slot.to(torch.int64), cnt


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def tri_intersect2(scene, origin, direction, t_max, any_hit: bool = False,
                   counters: bool = False, amask: int = 0):
    """Closest (or any) hit of a ray batch against the two-level tables.

    origin/direction [N,3] f32, t_max [N] f32 (or a scalar).  Returns
    dict(t, tri, inst, valid); amask=2 adds "solid" (module docstring).
    counters=True (CUDA only) adds "counters", per ray int32 [N,4] (L1
    table passes, L1 visits, leaf blocks tested, mask lookups), and
    "l1_touched" [M1] / "leaf_touched" [M2] bool, the L1s and child
    blocks any ray visited."""
    _check_mode(scene, any_hit, amask)
    n = origin.shape[0]
    origin = origin.to(torch.float32).contiguous()
    direction = direction.to(torch.float32).contiguous()
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=origin.device),
                               (n,)).contiguous()
    cnt = None
    if origin.is_cuda:
        t, slot, cnt = _launch_kernel(scene, origin, direction, t_max,
                                      any_hit, counters, amask)
    else:
        if counters:
            raise ValueError("counters come from the CUDA kernel only")
        t, slot = _plain_slots(scene, origin, direction, t_max, amask=amask)
    res = _result(scene, t, slot, amask)
    if cnt is not None:
        res.update(cnt)
    return res


tri_intersect2.launches = 0           # kernel launches, all modes
tri_intersect2.launches_by_mode = dict(closest=0, any_hit=0, amask1=0,
                                       amask2=0)


def reset_launches():
    """Set the kernel's launch counts (total and per mode) to 0."""
    tri_intersect2.launches = 0
    for k in tri_intersect2.launches_by_mode:
        tri_intersect2.launches_by_mode[k] = 0


def _check_mode(scene, any_hit, amask):
    if amask not in (0, 1, 2):
        raise ValueError(f"amask must be 0, 1 or 2, got {amask!r}")
    if amask and any_hit:
        # mode 1 filters a closest pass; mode 2 is its own predicate walk:
        # a plain any-hit would take mixed candidates for occluders
        raise ValueError("amask and any_hit are mutually exclusive")
    if amask and "pk_mask" not in scene:
        raise ValueError("amask needs tables built with tri_mask (pk_mask)")


def tri_intersect2_plain(scene, origin, direction, t_max,
                         any_hit: bool = False, prune: bool = True,
                         amask: int = 0):
    """The plain version on any device (the kernel's oracle on the card;
    never called on the render path).  prune=False tests every slot of
    the table instead of the triangles of the entered child blocks.
    any_hit changes nothing here: the nearest hit is also an occluder."""
    _check_mode(scene, any_hit, amask)
    n = origin.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=origin.device), (n,))
    return _result(scene, *_plain_slots(scene, origin.to(torch.float32),
                                        direction.to(torch.float32), t_max,
                                        prune, amask), amask)


def child_boxes_hold_triangles(scene, tri_v) -> bool:
    """Table check: every vertex of every data slot's triangle (tri_v
    [T,3,3], the triangles the tables were built from) lies in its child
    box, and every child with no data slot is a far-point box.  This is
    what makes culling by child box, in the kernel and in the plain
    version, unable to drop a hit."""
    box = scene["pk_l2box"]
    m2 = box.shape[0]
    s2t = scene["pk_slot2tri"].view(m2, -1)
    v = tri_v[torch.clamp(s2t, min=0).to(torch.int64)]     # [M2, K2, 3, 3]
    lo = box[:, None, None, 0:3]
    hi = box[:, None, None, 4:7]
    inside = ((v >= lo) & (v <= hi)).flatten(2).all(-1)
    empty = (s2t < 0).all(1)
    far = box[empty][:, [0, 1, 2, 4, 5, 6]] == 3e37
    return bool((inside | (s2t < 0)).all()) and bool(far.all())


def _result(scene, t, slot, amask=0):
    """(t, slot) per ray -> the dict(t, tri, inst, valid) contract, plus
    solid (slot == -2) under amask=2."""
    s2t = scene["pk_slot2tri"]
    valid = slot >= 0
    tri = torch.where(valid, s2t[torch.clamp(slot, 0, s2t.shape[0] - 1)], -1)
    valid = valid & (tri >= 0)
    res = dict(t=torch.where(valid, t, BIG_F32),
               tri=torch.where(valid, tri, -1).to(torch.int64),
               inst=torch.full(t.shape, -1, dtype=torch.int64,
                               device=t.device),
               valid=valid)
    if amask == 2:
        res["solid"] = slot == -2
    return res
