"""Single-level ray/triangle traversal over SAH block tables (counterpart
of pathtracing_tpu/accel/pallas_trace.py).

Tables (build_tri_blocks): the triangles are put in SAH order and cut into
blocks of K (a multiple of 128); a ray visits the block boxes it enters
nearest first and runs Moller-Trumbore on the K triangles of each.  The
scene builder gives triangle sets of 65,536 or fewer these tables, and
small instanced scenes the instanced ones (build_tri_blocks_inst): the
object-space triangles of each model once, and an instance-EXPANDED block
list of world boxes, each naming its physical block and its instance.  A
scene dict holds two-level tables iff it has "pk_l1_base"; these tables
have none.

`tri_intersect1` has the contract of the reference's
`pallas_tri_intersect` and of accel/trace2.py::tri_intersect2: dict(t, tri,
inst, valid) (+ "solid" under amask=2), t = BIG_F32 and tri = inst = -1 on
a miss.  For a CUDA tensor it launches the hand-written kernel in
csrc/trace1.cu (and raises if it cannot); for a CPU tensor it runs the
plain version `tri_intersect1_plain`: Moller-Trumbore, in the kernel's
arithmetic, over every triangle of every block whose padded box the ray
enters (every block with prune=False), no ordering, no early exit.  Ties
in t go to the least slot (instanced: the least expanded block, then the
least offset), the amask=2 contract is accel/trace2.py's order-independent
one, so kernel and plain version agree exactly.  Modes: closest, any-hit,
amask 1 / 2, instanced, motion (`time`); as in the reference the instanced
tables carry neither masks nor velocities, and masks exclude motion.  Hit
ids are int32 / int64: the reference's 2^24 guard protects its float32 hit
record and does not carry over.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cubuild
from .beam import pick_block_k
from .build import COARSE_G, coarse_tables
from .trace2 import (PlainBest, _MODE_BITS, _check_mode, _enters,
                     _moller_trumbore, _padded, _ptr, _ray_args,
                     box_corners, check_tensor,
                     instance_models, instance_rays, mode_name,
                     pack_tri_rows, sah_order, shutter_bounds,
                     staged_bytes, _check_mask_words)
from ..core.math import BIG_F32
from ..utils import profile

_CSRC = cubuild.source("trace1")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _box8(lo, hi):
    box = np.zeros((len(lo), 8), np.float32)
    box[:, 0:3] = lo
    box[:, 4:7] = hi
    return box


def build_tri_blocks(tri_v: np.ndarray, block_k: int | None = None,
                     tri_vel: np.ndarray | None = None,
                     shutter: tuple = (0.0, 0.0),
                     tri_mask: np.ndarray | None = None):
    """One-level block tables for a world triangle set.  Returns (arrays,
    block_k) with numpy arrays:
      pk_tri      [M, K, 12] f32 per slot: v0 xyz, e1 xyz, e2 xyz, velocity
                                  xyz (zeros when static); padded slots
                                  are zero rows.  K rides in the shape:
                                  the kernel wrapper and the plain version
                                  read it there
      pk_blk_lo/hi [M, 3] f32    block bounds (over the shutter interval
                                  with tri_vel / shutter)
      pk_blkbox   [M, 8] f32     the same, packed for the kernel
      pk_slot2tri [M*K] i32      slot -> triangle id, -1 on padding
      pk_sblk_lo/hi              coarse unions of 8 blocks (the
                                  reference's hierarchical sort key's)
      pk_cbox / pk_cmem / pk_cgrp  the kernel's coarse front over the
                                  same unions (build.coarse_tables)
      pk_mask     [M*K, 8] i32   only with tri_mask ([T,7] int32 words)
    K is a multiple of 128 (of 512 above 512) and M at most 4096, as in the
    reference package's build_tri_blocks, whose SAH order and block cut
    these are."""
    tri_v = np.asarray(tri_v, np.float32)
    if tri_vel is not None:
        tri_vel = np.asarray(tri_vel, np.float32)
        if tri_mask is not None:
            raise ValueError("alpha masks and motion exclude each other")
    lo, hi = shutter_bounds(tri_v, tri_vel, shutter)
    order = sah_order(lo, hi)
    n = len(order)
    k = block_k or max(128, -(-pick_block_k(n) // 128) * 128)
    while -(-n // k) > 4096:
        k += 128
    if k > 512:
        k = -(-k // 512) * 512
    m = -(-n // k)
    pad = m * k - n
    ord_pad = np.concatenate([order, np.repeat(order[-1:], pad)])
    tri = pack_tri_rows(tri_v[ord_pad],
                        tri_vel[ord_pad] if tri_vel is not None else None)
    plo = lo[ord_pad].reshape(m, k, 3).min(1).astype(np.float32)
    phi = hi[ord_pad].reshape(m, k, 3).max(1).astype(np.float32)
    slot2tri = ord_pad.astype(np.int32)
    if pad:
        slot2tri[n:] = -1
        tri[n:] = 0.0
    out = dict(pk_tri=tri.reshape(m, k, 12), pk_blk_lo=plo, pk_blk_hi=phi,
               pk_blkbox=_box8(plo, phi), pk_slot2tri=slot2tri,
               **coarse_tables(plo, phi))
    if tri_mask is not None:
        mask = np.zeros((m * k, 8), np.int32)
        mask[:n, :7] = _check_mask_words(tri_mask, len(tri_v))[order]
        out["pk_mask"] = mask
    return out, k


def build_tri_blocks_inst(tri_v, otri_v, inst_fwd, inst_inv, inst_base,
                          inst_count, block_k: int | None = None):
    """One-level INSTANCED block tables: object-space triangle rows once
    per model (world triangles first, then each model, each SAH-ordered),
    and the instance-expanded block list the kernel walks.  Returns
    (arrays, block_k): build_tri_blocks's arrays with
      pk_tri [Mp, K, 12] / pk_slot2tri [Mp*K]  PHYSICAL (slot -> world
                            triangle id for world blocks, object triangle
                            id for model blocks)
      pk_blk_lo/hi [Me, 3], pk_blkbox [Me, 8]  EXPANDED world bounds
      pk_blk_src  [Me] i32  expanded block -> physical block
      pk_blk_inst [Me] i32  expanded block -> instance (-1 world)
      pk_inst_inv / pk_inst_fwd [ni, 12] f32  row-major [3,4]
    in the reference package's build_tri_blocks_inst's order; the
    kernel's coarse front unites 8 expanded blocks that are neighbours in
    their SAH order (pk_sblk: 8 consecutive ones, the sort key's)."""
    tri_v = np.asarray(tri_v, np.float32).reshape(-1, 3, 3)
    otri_v = np.asarray(otri_v, np.float32).reshape(-1, 3, 3)
    inst_fwd = [np.asarray(f, np.float32) for f in inst_fwd]
    inst_inv = [np.asarray(f, np.float32) for f in inst_inv]
    nt = len(tri_v)
    ni = len(inst_fwd)
    models = instance_models(inst_base, inst_count)
    n_eff = nt + sum(int(inst_count[i]) for i in range(ni))
    k = block_k or max(128, -(-pick_block_k(max(n_eff, 1)) // 128) * 128)

    def n_expanded(k):
        me = -(-nt // k) if nt else 0
        for (_, count), insts in models.items():
            me += (-(-count // k)) * len(insts)
        return me

    while n_expanded(k) > 4096:
        k += 128
    if k > 512:
        k = -(-k // 512) * 512

    rows, slot2tri = [], []
    exp_lo, exp_hi, exp_src, exp_inst = [], [], [], []
    phys_blocks = 0

    def emit_source(v_sub, glob_ids):
        nonlocal phys_blocks
        order = sah_order(v_sub.min(1), v_sub.max(1))
        n = len(order)
        mb = -(-n // k)
        pad = mb * k - n
        ord_pad = np.concatenate([order, np.repeat(order[-1:], pad)])
        row = pack_tri_rows(v_sub[ord_pad])
        row[n:] = 0.0                  # padded slots: zero rows, never hit
        rows.append(row)
        s2t = glob_ids[ord_pad].astype(np.int32)
        if pad:
            s2t[n:] = -1
        slot2tri.append(s2t)
        lo = v_sub[ord_pad].min(1).reshape(mb, k, 3).min(1)
        hi = v_sub[ord_pad].max(1).reshape(mb, k, 3).max(1)
        src = np.arange(phys_blocks, phys_blocks + mb, dtype=np.int32)
        phys_blocks += mb
        return src, lo, hi

    if nt:
        src, lo, hi = emit_source(tri_v, np.arange(nt))
        exp_lo.append(lo)
        exp_hi.append(hi)
        exp_src.append(src)
        exp_inst.append(np.full(len(src), -1, np.int32))
    for (base, count), insts in models.items():
        src, lo, hi = emit_source(otri_v[base:base + count],
                                  np.arange(base, base + count))
        corners = box_corners(lo, hi)
        for i in insts:
            f = inst_fwd[i]
            wc = corners @ f[:3, :3].T + f[:3, 3]
            exp_lo.append(wc.min(1))
            exp_hi.append(wc.max(1))
            exp_src.append(src)
            exp_inst.append(np.full(len(src), i, np.int32))
    blo = np.concatenate(exp_lo, 0).astype(np.float32)
    bhi = np.concatenate(exp_hi, 0).astype(np.float32)
    return dict(
        pk_tri=np.concatenate(rows, 0).reshape(-1, k, 12),
        pk_blk_lo=blo, pk_blk_hi=bhi, pk_blkbox=_box8(blo, bhi),
        pk_blk_src=np.concatenate(exp_src, 0),
        pk_blk_inst=np.concatenate(exp_inst, 0),
        pk_slot2tri=np.concatenate(slot2tri, 0),
        pk_inst_inv=np.stack([f[:3, :4].reshape(12) for f in inst_inv]),
        pk_inst_fwd=np.stack([f[:3, :4].reshape(12) for f in inst_fwd]),
        **coarse_tables(blo, bhi,
                        sah_order(blo, bhi) if len(blo) else None)), k


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _plain_slots(scene, origin, direction, t_max, prune=True, amask=0,
                 time=None):
    """Nearest (t, key) per ray over every triangle of every block the ray
    enters (every block when prune is False); key = expanded block * K +
    offset (the table slot for plain tables); a `solid` lane of amask=2
    is key -2."""
    tri = scene["pk_tri"]
    k = tri.shape[1]
    mask = scene["pk_mask"].view(-1, k, 8) if amask else None
    me = scene["pk_blkbox"].shape[0]
    dev = origin.device
    inst_tab = "pk_blk_src" in scene
    if inst_tab:
        src = scene["pk_blk_src"].to(torch.int64)
        inst = scene["pk_blk_inst"].to(torch.int64)
    lo, hi = _padded(scene["pk_blkbox"])
    n = origin.shape[0]
    best = PlainBest(n, dev, amask)
    budget = 1 << (26 if origin.is_cuda else 20)
    rchunk = max(1, budget // (4 * max(1, me)))
    pchunk = max(1, budget // (8 * k))
    for r0 in range(0, n, rchunk):
        o_c, d_c = origin[r0:r0 + rchunk], direction[r0:r0 + rchunk]
        if prune:
            profile.count("host_syncs")
            ray, e = torch.nonzero(_enters(
                lo[None], hi[None], o_c[:, None], d_c[:, None],
                t_max[r0:r0 + rchunk, None])).unbind(1)
        else:
            nr = o_c.shape[0]
            ray = torch.arange(nr, device=dev).repeat_interleave(me)
            e = torch.arange(me, device=dev).repeat(nr)
        ray = ray + r0
        for p0 in range(0, ray.shape[0], pchunk):
            r, ee = ray[p0:p0 + pchunk], e[p0:p0 + pchunk]
            if inst_tab:
                ol, dl = instance_rays(scene["pk_inst_inv"], inst[ee],
                                       origin[r], direction[r])
                blk = src[ee]
            else:
                ol, dl, blk = origin[r], direction[r], ee
            t, ok, u, v = _moller_trumbore(
                ol, dl, tri[blk], t_max[r],
                time[r] if time is not None else None)
            best.update(r, ee * k, t, ok, u, v, mask[blk] if amask else None)
    return best.result()


# ---------------------------------------------------------------------------
# CUDA kernel: build + launch
# ---------------------------------------------------------------------------

_lib = None


def build_kernel() -> float:
    """Compile csrc/trace1.cu (if not built yet) and load it.  Returns the
    seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    _lib = bind(cubuild.load("trace1"))
    return profile.counters()["kernels.trace1_s"]


def bind(lib):
    """Declare trace1_launch's (and trace1_occupancy's) C signature on a
    loaded library (the CUDA build, or cubuild.host_library's host
    build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.trace1_launch.restype = I
    lib.trace1_launch.argtypes = [P, P, P, I, P, I, P, I, P, P, P, P, I, I,
                                  I, P, P, P, P, P, P, P, P, P, P]
    lib.trace1_occupancy.restype = I
    lib.trace1_occupancy.argtypes = [I, I, P]
    return lib


def occupancy(mode, smem=0, lib=None):
    """Blocks of 128 threads per SM of a mode's kernel with `smem` bytes of
    staged coarse table, from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    mode is a MODES name."""
    _, amask, inst, motion = _MODE_BITS[mode]
    code = 3 if inst else (4 if motion else amask)
    out = ctypes.c_int(0)
    rc = (lib or _lib).trace1_occupancy(code, int(smem), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"trace1_occupancy failed (cudaError {rc})")
    return out.value


def _launch_kernel(scene, origin, direction, t_max, any_hit, counters,
                   amask, time=None, host_lib=None):
    """Launch the kernel on CUDA tensors.  host_lib: a cubuild.host_library
    build, run on CPU tensors instead (the kernel's logic where there is
    no GPU; not counted as a launch)."""
    if host_lib is None:
        build_kernel()
    dev = origin.device
    n = origin.shape[0]
    tri, box = scene["pk_tri"], scene["pk_blkbox"]
    if "pk_cbox" not in scene:
        raise ValueError("trace1: the tables lack the coarse front (pk_cbox, "
                         "pk_cmem, pk_cgrp of build_tri_blocks / "
                         "build_tri_blocks_inst)")
    coarse, cmem, cgrp = scene["pk_cbox"], scene["pk_cmem"], scene["pk_cgrp"]
    inst = "pk_blk_src" in scene
    checks = [("origin", origin, torch.float32),
              ("direction", direction, torch.float32),
              ("t_max", t_max, torch.float32),
              ("pk_tri", tri, torch.float32),
              ("pk_blkbox", box, torch.float32),
              ("pk_cbox", coarse, torch.float32),
              ("pk_cmem", cmem, torch.int32),
              ("pk_cgrp", cgrp, torch.int32)]
    mask = src = binst = inv = None
    if amask:
        mask = scene["pk_mask"]
        checks.append(("pk_mask", mask, torch.int32))
    if inst:
        src, binst = scene["pk_blk_src"], scene["pk_blk_inst"]
        inv = scene["pk_inst_inv"]
        checks += [("pk_blk_src", src, torch.int32),
                   ("pk_blk_inst", binst, torch.int32),
                   ("pk_inst_inv", inv, torch.float32)]
    if time is not None:
        checks.append(("time", time, torch.float32))
    for name, x, dt in checks:
        check_tensor("trace1", name, x, dt, dev)
    m = box.shape[0]
    if (origin.shape != (n, 3) or direction.shape != (n, 3)
            or tri.ndim != 3 or tri.shape[2] != 12 or box.shape[1:] != (8,)
            or (not inst and tri.shape[0] != m)
            or coarse.ndim != 2 or coarse.shape[1] != 8
            or cmem.shape != (coarse.shape[0], COARSE_G)
            or cgrp.shape != (m,)
            or (time is not None and time.shape != (n,))
            or (amask and mask.shape != (tri.shape[0] * tri.shape[1], 8))
            or (inst and (src.shape != (m,) or binst.shape != (m,)
                          or inv.ndim != 2 or inv.shape[1] != 12))):
        raise ValueError("trace1: ray or table shapes do not match the "
                         "build_tri_blocks / build_tri_blocks_inst layout")
    k = tri.shape[1]
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    out_blk = (torch.empty((n,), dtype=torch.int32, device=dev) if inst
               else None)
    cnt = touched = None
    if counters:
        cnt = torch.zeros((n, 5), dtype=torch.int32, device=dev)
        touched = torch.zeros((tri.shape[0],), dtype=torch.uint8,
                              device=dev)
    stream = None
    if host_lib is None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
    rc = (host_lib or _lib).trace1_launch(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), n,
        box.data_ptr(), m, coarse.data_ptr(), coarse.shape[0],
        cmem.data_ptr(), cgrp.data_ptr(), tri.data_ptr(), _ptr(mask), k,
        int(bool(any_hit)), int(amask), _ptr(src), _ptr(binst), _ptr(inv),
        _ptr(time), out_t.data_ptr(), out_slot.data_ptr(), _ptr(out_blk),
        _ptr(cnt), _ptr(touched), stream)
    if rc != 0:
        raise RuntimeError(f"trace1 kernel launch failed (cudaError {rc})")
    if host_lib is None:
        tri_intersect1.launches += 1
        tri_intersect1.launches_by_mode[mode_name(
            any_hit, amask, inst, time is not None)] += 1
    if counters:
        cnt = dict(counters=cnt, blocks_touched=touched.bool())
    slot = out_slot.to(torch.int64)
    if inst:    # (expanded block, offset) -> the plain version's key
        slot = torch.where(slot >= 0, out_blk.to(torch.int64) * k + slot,
                           slot)
    return out_t, slot, cnt


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def _check_mode1(scene, any_hit, amask, time):
    _check_mode(scene, any_hit, amask, time)
    if "pk_blk_src" in scene and (amask or time is not None):
        raise ValueError("the single-level instanced tables carry neither "
                         "alpha masks nor velocities")


def tri_intersect1(scene, origin, direction, t_max, any_hit: bool = False,
                   counters: bool = False, amask: int = 0, time=None):
    """Closest (or any) hit of a ray batch against the one-level tables.

    origin/direction [N,3] f32, t_max [N] f32 (or a scalar), time [N] f32
    for tables built with velocities.  Returns dict(t, tri, inst, valid),
    "solid" under amask=2; counters=True (CUDA only) adds
    "counters", per ray int32 [N,5] (front refills, blocks visited, the
    same again, mask lookups, top-level slab tests: coarse unions and
    blocks), and "blocks_touched" [Mp] bool, the physical blocks any ray
    visited."""
    _check_mode1(scene, any_hit, amask, time)
    origin, direction, t_max, time = _ray_args(origin, direction, t_max, time)
    cnt = None
    if origin.is_cuda:
        with profile.span("k2.launch"):
            t, key, cnt = _launch_kernel(scene, origin, direction, t_max,
                                         any_hit, counters, amask, time)
    else:
        if counters:
            raise ValueError("counters come from the CUDA kernel only")
        t, key = _plain_slots(scene, origin, direction, t_max, amask=amask,
                              time=time)
    res = _result(scene, t, key, amask)
    if cnt is not None:
        res.update(cnt)
    return res


MODES = ("closest", "any_hit", "amask1", "amask2", "inst_closest",
         "inst_any_hit", "motion_closest", "motion_any_hit")
tri_intersect1.launches = 0           # kernel launches, all modes
tri_intersect1.launches_by_mode = {m: 0 for m in MODES}


def reset_launches():
    """Set the kernel's launch counts (total and per mode) to 0."""
    tri_intersect1.launches = 0
    for k in tri_intersect1.launches_by_mode:
        tri_intersect1.launches_by_mode[k] = 0


def tri_intersect1_plain(scene, origin, direction, t_max,
                         any_hit: bool = False, prune: bool = True,
                         amask: int = 0, time=None):
    """The plain version on any device (the kernel's oracle on the card;
    never called on the render path).  prune=False tests every slot of
    the table.  any_hit changes nothing here: the nearest hit is also an
    occluder."""
    _check_mode1(scene, any_hit, amask, time)
    origin, direction, t_max, time = _ray_args(origin, direction, t_max, time)
    return _result(scene, *_plain_slots(scene, origin, direction, t_max,
                                        prune, amask, time), amask)


def _result(scene, t, key, amask=0):
    """(t, key) per ray -> dict(t, tri, inst, valid) (+ solid).  Instanced
    tables: key = expanded block * K + offset; the instance is the
    expanded block's, the triangle the slot `offset` of its physical
    block."""
    s2t = scene["pk_slot2tri"]
    valid = key >= 0
    kc = torch.clamp(key, min=0)
    if "pk_blk_src" in scene:
        k = scene["pk_tri"].shape[1]
        e = torch.clamp(kc // k, max=scene["pk_blk_src"].shape[0] - 1)
        slot = scene["pk_blk_src"][e].to(torch.int64) * k + kc % k
        inst = scene["pk_blk_inst"][e].to(torch.int64)
    else:
        slot = kc
        inst = torch.full(t.shape, -1, dtype=torch.int64, device=t.device)
    tri = torch.where(valid, s2t[torch.clamp(slot, 0, s2t.shape[0] - 1)], -1)
    valid = valid & (tri >= 0)
    res = dict(t=torch.where(valid, t, BIG_F32),
               tri=torch.where(valid, tri, -1).to(torch.int64),
               inst=torch.where(valid, inst, -1),
               valid=valid)
    if amask == 2:
        res["solid"] = key == -2
    return res
