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

Instanced tables (build_tri_blocks2_inst; "pk_blk_src" in the scene): the
L1 list is instance-expanded, each entry a world box, a physical L1 and
an instance whose inverse affine takes the ray to object space (direction
unnormalized, so t stays the world parameter).  A hit is the pair
(expanded L1, offset in it); ties in t go to the least pair.  `inst` is
the hit's instance (-1 for a world triangle) and `tri` then indexes the
object-space triangle table.  Motion (`time` [N], tables built with
tri_vel / inst_vel): a triangle row's floats 9..11 are its velocity, a
moving instance has an object-space velocity row in pk_inst_velo; the
leaf test shifts the ray origin by -velocity * time.  Hit ids are int32 /
int64 throughout: the reference's 2^24 guards protect its float32 hit
records and do not carry over.

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

Schedules (pops, window) change the order of the kernel's work, never
its result.  The reference's visit cap with its multipass resume state,
its paired visits and its re-cull cadence have no counterpart: none
changes a result and none won on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import BIG_F32, SHADOW_EPS
from . import cubuild
from .build import COARSE_G, coarse_tables, sah_order
from ..utils import profile

G_DEFAULT = 16      # child blocks per L1 superblock
TILE = 128          # dispatch pads ray batches to a multiple of this
WIDEN = torch.tensor(1.0000005, dtype=torch.float32)   # the kernel's slab widening

_CSRC = cubuild.source("trace2")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def shutter_bounds(tri_v, tri_vel=None, shutter=(0.0, 0.0)):
    """Per-triangle boxes (lo, hi) [n,3]; with tri_vel [n,3] the union
    over the shutter interval of the linearly moving triangle."""
    lo = tri_v.min(1)
    hi = tri_v.max(1)
    if tri_vel is not None:
        d0 = tri_vel * float(shutter[0])
        d1 = tri_vel * float(shutter[1])
        lo = lo + np.minimum(d0, d1)
        hi = hi + np.maximum(d0, d1)
    return lo, hi


def pack_tri_rows(v, vel=None):
    """[n,3,3] vertices (+ [n,3] velocities) -> [n,12] kernel rows: v0 xyz,
    e1 xyz, e2 xyz, velocity xyz (zeros when static)."""
    v0 = v[:, 0]
    rows = np.zeros((len(v), 12), np.float32)
    rows[:, 0:3] = v0
    rows[:, 3:6] = v[:, 1] - v0
    rows[:, 6:9] = v[:, 2] - v0
    if vel is not None:
        rows[:, 9:12] = vel
    return rows


def _check_mask_words(mask, n):
    mask = np.asarray(mask)
    if mask.dtype != np.int32 or mask.shape != (n, 7):
        raise ValueError("alpha mask words must be int32 [T, 7]")
    return mask


def build_tri_blocks2(tri_v: np.ndarray, k2: int | None = None,
                      g: int = G_DEFAULT, tri_mask: np.ndarray | None = None,
                      tri_vel: np.ndarray | None = None,
                      shutter: tuple = (0.0, 0.0)):
    """Two-level block tables for a world triangle set.  Returns
    (arrays, k2) with numpy arrays:
      pk_tri      [M2*K2, 12] f32  per slot: v0 xyz, e1 xyz, e2 xyz, then
                                    the velocity xyz (zeros when static);
                                    three 16-byte loads per triangle;
                                    padded slots are zero rows (det == 0,
                                    never hit)
      pk_l2box    [M2, 8] f32      child boxes lo xyz 0 hi xyz 0; padded
                                    children are far-point boxes
                                    (lo == hi == 3e37, never entered)
      pk_blk_lo/hi [M1, 3] f32     L1 bounds (data children only)
      pk_l1box    [M1, 8] f32      the same, packed for the kernel
      pk_l1_base  [M1] i32         first child block of each L1
      pk_slot2tri [M2*K2] i32      slot -> triangle id, -1 on padding
      pk_sblk_lo/hi                coarse unions of 8 L1s (the
                                    reference's hierarchical sort key's)
      pk_cbox     [C, 8] f32       the same unions packed for the kernel's
                                    coarse front: lo xyz, the int32 bits of
                                    the least member, hi xyz, 0
      pk_cmem     [C, 8] i32       each union's L1s, ascending, -1 padded
      pk_cgrp     [M1] i32         the union of each L1
      pk_mask     [M2*K2, 8] i32   only with tri_mask ([T, 7] int32 alpha
                                    micro-mask words per triangle): the 7
                                    words + 1 pad per slot (two 16-byte
                                    loads), zero on padded slots
    tri_vel [T,3] / shutter: linear motion; boxes are the union over the
    shutter interval (masks and motion exclude each other, as in the
    reference, whose tables share rows between them).
    The SAH order, the block cut and the L1 grouping are those of the
    reference package's build_tri_blocks2 (same builder, same triangles
    => same tables)."""
    tri_v = np.asarray(tri_v, np.float32)
    if tri_vel is not None:
        tri_vel = np.asarray(tri_vel, np.float32)
        if tri_mask is not None:
            raise ValueError("alpha masks and motion exclude each other")
    lo, hi = shutter_bounds(tri_v, tri_vel, shutter)
    order = sah_order(lo, hi)
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
    tri = pack_tri_rows(tri_v[ord_pad],
                        tri_vel[ord_pad] if tri_vel is not None else None)
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
               **coarse_tables(l1lo, l1hi))
    if tri_mask is not None:
        mask = np.zeros((m2 * k2, 8), np.int32)
        mask[:n, :7] = _check_mask_words(tri_mask, len(tri_v))[order]
        out["pk_mask"] = mask
    return out, k2


def box_corners(lo, hi):
    """[m,3] lo/hi -> [m,8,3] corners (corner c takes hi on axis a where
    bit a of c is set)."""
    return np.stack([np.stack([np.where(c & (1 << a), hi[:, a], lo[:, a])
                               for a in range(3)], -1) for c in range(8)], 1)


def instance_models(inst_base, inst_count):
    """{(base, count): [instance ids]} in first-use order."""
    models = {}
    for i in range(len(inst_base)):
        models.setdefault((int(inst_base[i]), int(inst_count[i])),
                          []).append(i)
    return models


def build_tri_blocks2_inst(tri_v, otri_v, inst_fwd, inst_inv, inst_base,
                           inst_count, k2: int | None = None,
                           g: int = G_DEFAULT, tri_sel=None, otri_sel=None,
                           tri_vel=None, inst_vel=None,
                           shutter: tuple = (0.0, 0.0),
                           tri_mask=None, otri_mask=None):
    """Two-level INSTANCED block tables.  Object-space geometry (triangle
    rows and child boxes) is stored once per model; the L1 list the kernel
    orders and walks is instance-expanded: each entry is a world box (the
    model L1's object box pushed through the instance transform), the
    physical L1 whose children to walk and the instance whose inverse
    transform takes the ray there.

    tri_v [nt,3,3] world triangles, otri_v [no,3,3] object-space triangles,
    inst_fwd / inst_inv: per instance [3,4] (or 4x4) forward / inverse
    affine, inst_base / inst_count: each instance's range of otri_v.
    tri_sel / otri_sel: bool masks restricting which world / object
    triangles the tables cover (the alpha-material split); pk_slot2tri
    always names GLOBAL ids; an instance whose model has no selected
    triangle emits no L1.  tri_vel [nt,3] / inst_vel [ni,3] / shutter:
    linear motion (world rows carry their velocity, a moving instance's
    world boxes are the union over the shutter).  tri_mask [nt,7] /
    otri_mask [no,7]: int32 alpha micro-mask words (no motion then).

    Returns (arrays, k2): build_tri_blocks2's arrays with
      pk_tri / pk_l2box / pk_slot2tri / pk_mask  PHYSICAL (world rows
                                 first, then each model once; object space
                                 for model rows)
      pk_l1_base   [M1p] i32     physical L1 -> its first child block
      pk_blk_lo/hi [M1e, 3], pk_l1box [M1e, 8]  EXPANDED world L1 bounds
      pk_blk_src   [M1e] i32     expanded L1 -> physical L1
      pk_blk_inst  [M1e] i32     expanded L1 -> instance (-1 world)
      pk_inst_inv / pk_inst_fwd [ni, 12] f32  row-major [3,4]
      pk_inst_velo [ni, 3] f32   object-space instance velocities
    The SAH orders, the L1 grouping, the expansion order and the slot ids
    are the reference package's build_tri_blocks2_inst's."""
    G = g
    tri_v = np.asarray(tri_v, np.float32).reshape(-1, 3, 3)
    otri_v = np.asarray(otri_v, np.float32).reshape(-1, 3, 3)
    inst_fwd = [np.asarray(f, np.float32) for f in inst_fwd]
    inst_inv = [np.asarray(f, np.float32) for f in inst_inv]
    nt = len(tri_v)
    ni = len(inst_fwd)
    world_ids = (np.nonzero(np.asarray(tri_sel, bool))[0]
                 if tri_sel is not None else np.arange(nt))
    otri_sel = (np.asarray(otri_sel, bool) if otri_sel is not None
                else np.ones(len(otri_v), bool))
    if tri_vel is not None:
        tri_vel = np.asarray(tri_vel, np.float32)
    inst_vel = (np.asarray(inst_vel, np.float32) if inst_vel is not None
                else np.zeros((max(ni, 1), 3), np.float32))
    s0, s1 = float(shutter[0]), float(shutter[1])
    models = instance_models(inst_base, inst_count)
    model_ids = {bc: bc[0] + np.nonzero(otri_sel[bc[0]:bc[0] + bc[1]])[0]
                 for bc in models}

    if k2 is None:
        # aim for <= 4096 expanded L1s, but stop as soon as a larger k2
        # stops reducing the count (every instance needs >= 1 L1)
        def n_l1_expanded(k2):
            def l1_of(n):
                return -(-(-(-n // k2)) // G) if n else 0
            me = l1_of(len(world_ids))
            for bc, insts in models.items():
                me += l1_of(len(model_ids[bc])) * len(insts)
            return me

        k2 = 128
        while (n_l1_expanded(k2) > 4096
               and n_l1_expanded(k2 + 128) < n_l1_expanded(k2)):
            k2 += 128

    use_mask = tri_mask is not None or otri_mask is not None
    if use_mask and (tri_vel is not None or np.abs(inst_vel).any()):
        raise ValueError("alpha masks and motion exclude each other")
    if tri_mask is not None:
        tri_mask = _check_mask_words(tri_mask, nt)
    if otri_mask is not None:
        otri_mask = _check_mask_words(otri_mask, len(otri_v))
    rows, masks, slot2tri, l2boxes = [], [], [], []
    exp_lo, exp_hi, exp_src, exp_inst = [], [], [], []
    l1_bases = []
    phys_l1 = 0
    phys_blocks = 0

    def emit_source(v_sub, glob_ids, vel_sub=None, mask_sub=None):
        """SAH-order one triangle soup and cut it into child blocks and
        L1s; returns per L1 (physical ids, source-space lo / hi)."""
        nonlocal phys_l1, phys_blocks
        order = sah_order(v_sub.min(1), v_sub.max(1))
        n = len(order)
        m2 = -(-n // k2)
        m2 = -(-m2 // G) * G
        pad = m2 * k2 - n
        ord_pad = np.concatenate([order, np.repeat(order[-1:], pad)])
        row = pack_tri_rows(
            v_sub[ord_pad], vel_sub[ord_pad] if vel_sub is not None else None)
        row[n:] = 0.0                  # padded slots: zero rows, never hit
        rows.append(row)
        if use_mask:
            mk = np.zeros((len(ord_pad), 8), np.int32)
            if mask_sub is not None:
                mk[:n, :7] = mask_sub[order]
            masks.append(mk)
        s2t = glob_ids[ord_pad].astype(np.int32)
        if pad:
            s2t[n:] = -1
        slot2tri.append(s2t)
        lo, hi = shutter_bounds(v_sub, vel_sub, (s0, s1))
        l2lo = lo[ord_pad].reshape(m2, k2, 3).min(1)
        l2hi = hi[ord_pad].reshape(m2, k2, 3).max(1)
        nb_data = -(-n // k2)
        if m2 > nb_data:
            l2lo[nb_data:] = 3e37      # degenerate far-point empty box
            l2hi[nb_data:] = 3e37
        m1 = m2 // G
        box = np.zeros((m2, 8), np.float32)
        box[:, 0:3] = l2lo
        box[:, 4:7] = l2hi
        l2boxes.append(box)
        # L1 bounds span only data blocks: a far-point (3e37) corner would
        # overflow through the instance transform and the box would test
        # as entered first by every ray
        l2lo_d = np.where(l2lo >= 3e37, np.inf, l2lo)
        l2hi_d = np.where(l2hi >= 3e37, -np.inf, l2hi)
        l1lo = l2lo_d.reshape(m1, G, 3).min(1)
        l1hi = l2hi_d.reshape(m1, G, 3).max(1)
        src = np.arange(phys_l1, phys_l1 + m1, dtype=np.int32)
        l1_bases.append(phys_blocks + np.arange(m1, dtype=np.int32) * G)
        phys_l1 += m1
        phys_blocks += m2
        return src, l1lo, l1hi

    if len(world_ids):
        src, lo, hi = emit_source(
            tri_v[world_ids], world_ids,
            tri_vel[world_ids] if tri_vel is not None else None,
            tri_mask[world_ids] if tri_mask is not None else None)
        exp_lo.append(lo)
        exp_hi.append(hi)
        exp_src.append(src)
        exp_inst.append(np.full(len(src), -1, np.int32))

    for bc, insts in models.items():
        ids = model_ids[bc]
        if not len(ids):
            continue                  # model fully outside this subset
        src, lo, hi = emit_source(
            otri_v[ids], ids,
            mask_sub=otri_mask[ids] if otri_mask is not None else None)
        corners = box_corners(lo, hi)                       # [m1,8,3]
        for i in insts:
            f = inst_fwd[i]
            wc = corners @ f[:3, :3].T + f[:3, 3]
            d0 = inst_vel[i] * s0     # moving instance: union over shutter
            d1 = inst_vel[i] * s1
            exp_lo.append(wc.min(1) + np.minimum(d0, d1))
            exp_hi.append(wc.max(1) + np.maximum(d0, d1))
            exp_src.append(src)
            exp_inst.append(np.full(len(src), i, np.int32))

    # object-space instance velocities: v_obj = inv_lin @ v_world
    velo = np.stack([inst_inv[i][:3, :3] @ inst_vel[i] if ni else
                     np.zeros(3, np.float32) for i in range(max(ni, 1))])
    blo = np.concatenate(exp_lo, 0).astype(np.float32)
    bhi = np.concatenate(exp_hi, 0).astype(np.float32)
    l1box = np.zeros((len(blo), 8), np.float32)
    l1box[:, 0:3] = blo
    l1box[:, 4:7] = bhi

    def rows12(mats):
        if not mats:
            return np.zeros((1, 12), np.float32)
        return np.stack([f[:3, :4].reshape(12) for f in mats])

    out = dict(
        pk_tri=np.concatenate(rows, 0),
        pk_l2box=np.concatenate(l2boxes, 0),
        pk_blk_lo=blo, pk_blk_hi=bhi, pk_l1box=l1box,
        **coarse_tables(blo, bhi, sah_order(blo, bhi) if len(blo) else None),
        pk_blk_src=np.concatenate(exp_src, 0),
        pk_blk_inst=np.concatenate(exp_inst, 0),
        pk_l1_base=np.concatenate(l1_bases, 0),
        pk_slot2tri=np.concatenate(slot2tri, 0),
        pk_inst_inv=rows12(inst_inv), pk_inst_fwd=rows12(inst_fwd),
        pk_inst_velo=velo.astype(np.float32))
    if use_mask:
        out["pk_mask"] = np.concatenate(masks, 0)
    return out, k2


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _moller_trumbore(o, d, tri, t_max, time=None):
    """(t, ok, u, v) of each (ray, slot) pair, t = BIG_F32 on a miss: o, d
    [P, 3], tri [P, K, 12] table rows, t_max [P]; the kernel's
    arithmetic.  u, v are the barycentrics (garbage where not ok).  time
    [P]: the rows' floats 9..11 are velocities and the origin is shifted
    by -velocity * time."""
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
    if time is not None:
        tt = time[:, None]
        sx = sx - tri[..., 9] * tt
        sy = sy - tri[..., 10] * tt
        sz = sz - tri[..., 11] * tt
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


def _padded(box):
    """(lo, hi) of the [M, 8] box table, padded by 1e-4 of each box's size
    and magnitude: far above the rounding of a hit point, so culling by
    the padded box drops no box that holds a hit."""
    lo, hi = box[:, 0:3], box[:, 4:7]
    pad = 1e-4 * (hi - lo + torch.maximum(lo.abs(), hi.abs()))
    return lo - pad, hi + pad


def _enters(lo, hi, o, d, t_max):
    """Slab test of boxes lo / hi against rays o / d below t_max
    (broadcast over leading dims; the last dim is xyz)."""
    tiny = torch.where(d < 0, -1e-32, 1e-32)
    inv = 1.0 / torch.where(d.abs() < 1e-32, tiny, d)
    a = (lo - o) * inv
    b = (hi - o) * inv
    tn = torch.minimum(a, b).amax(-1).clamp(min=0.0)
    tf = torch.minimum(torch.maximum(a, b).amin(-1), t_max)
    return tn <= tf


def _entered_children(scene, o, d, t_max):
    """(ray, child) pairs whose padded child box the ray enters below
    t_max."""
    lo, hi = _padded(scene["pk_l2box"])
    profile.count("host_syncs")
    return torch.nonzero(_enters(lo[None], hi[None], o[:, None], d[:, None],
                                 t_max[:, None])).unbind(1)


def instance_rays(inv, inst, o, d, velo=None, time=None):
    """Object-space rays of the pairs (o, d [P,3], inst [P]): the inverse
    affine rows inv [ni,12] applied in the kernel's order of sums, the
    direction left unnormalized; velo [ni,3] / time [P] shift the origin
    by -velocity * time.  inst < 0 leaves the ray as it is."""
    m = inv[torch.clamp(inst, 0, inv.shape[0] - 1)]
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ol = [m[:, 4 * r] * ox + m[:, 4 * r + 1] * oy + m[:, 4 * r + 2] * oz
          + m[:, 4 * r + 3] for r in range(3)]
    dl = [m[:, 4 * r] * dx + m[:, 4 * r + 1] * dy + m[:, 4 * r + 2] * dz
          for r in range(3)]
    if velo is not None and time is not None:
        vl = velo[torch.clamp(inst, 0, velo.shape[0] - 1)]
        ol = [ol[r] - vl[:, r] * time for r in range(3)]
    use = (inst >= 0)[:, None]
    return (torch.where(use, torch.stack(ol, -1), o),
            torch.where(use, torch.stack(dl, -1), d))


_I64_MAX = torch.iinfo(torch.int64).max


class PlainBest:
    """Running nearest hit per ray of a plain (unordered) traversal: the
    least t, exact ties to the least key; amask 1 / 2 as in the module
    docstring (a `solid` lane of mode 2 ends as key -2)."""

    def __init__(self, n, dev, amask):
        self.amask = amask
        self.t = torch.full((n,), BIG_F32, dtype=torch.float32, device=dev)
        self.key = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.t_opq = torch.full((n,), BIG_F32, dtype=torch.float32,
                                device=dev)

    def update(self, r, key0, t, ok, u=None, v=None, mask=None):
        """Fold the tests t / ok [P, K] of rays r [P] in; entry (p, k) has
        key key0[p] + k.  mask [P, K, 8]: the slots' alpha words."""
        if self.amask:
            opq, mix = _alpha_cell_bits(mask, u, v)
            if self.amask == 1:
                t = torch.where(ok & (opq | mix), t, BIG_F32)
            else:
                self.t_opq = self.t_opq.scatter_reduce(
                    0, r, torch.where(ok & opq, t, BIG_F32).amin(1), "amin")
                t = torch.where(ok & mix, t, BIG_F32)
        pt, pk = torch.min(t, dim=1)         # first min: least key in a row
        ps = key0 + pk
        new_t = self.t.scatter_reduce(0, r, pt, "amin")
        cand = torch.where((pt == new_t[r]) & (pt < BIG_F32), ps, _I64_MAX)
        keep = torch.where(new_t == self.t, self.key, _I64_MAX)
        self.key = keep.scatter_reduce(0, r, cand, "amin")
        self.t = new_t

    def result(self):
        t = self.t
        key = torch.where(t < BIG_F32, self.key, -1)
        if self.amask == 2:
            solid = self.t_opq < t
            t = torch.where(solid, BIG_F32, t)
            key = torch.where(solid, -2, key)
        return t, key


def _plain_slots(scene, origin, direction, t_max, prune=True, amask=0,
                 time=None):
    """Nearest (t, key) per ray, by Moller-Trumbore over every triangle of
    every child block the ray enters (every child block when prune is
    False); no ordering, no early exit; ties in t go to the least key.
    The key is the table slot; for instanced tables it is
    expanded L1 * (G * K2) + the offset inside that L1.  amask 1 / 2: the
    alpha micro-mask modes of the module docstring; a `solid` lane of
    mode 2 is reported as key -2."""
    if "pk_blk_src" in scene or time is not None:
        return _plain_slots_general(scene, origin, direction, t_max, prune,
                                    amask, time)
    tri = scene["pk_tri"]
    m2 = scene["pk_l2box"].shape[0]
    k2 = tri.shape[0] // m2
    tri = tri.view(m2, k2, 12)
    mask = scene["pk_mask"].view(m2, k2, 8) if amask else None
    n = origin.shape[0]
    dev = origin.device
    best = PlainBest(n, dev, amask)
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
            best.update(r, c * k2, t, ok, u, v, mask[c] if amask else None)
    return best.result()


class _PairFolder:
    """The plain version's visit of (ray, expanded L1) pairs, for any
    table kind: each ray goes to the L1's source space (instanced tables),
    the children of the physical L1 it enters (padded boxes; all of them
    when prune is False) have their triangles tested there, and the hits
    are folded into a PlainBest."""

    def __init__(self, scene, origin, direction, t_max, time, amask,
                 prune=True):
        tri = scene["pk_tri"]
        self.m2 = scene["pk_l2box"].shape[0]
        self.k2 = tri.shape[0] // self.m2
        self.tri = tri.view(self.m2, self.k2, 12)
        self.mask = (scene["pk_mask"].view(self.m2, self.k2, 8) if amask
                     else None)
        self.l1_base = scene["pk_l1_base"].to(torch.int64)
        self.g = self.m2 // self.l1_base.shape[0]
        self.m1e = scene["pk_l1box"].shape[0]
        self.inst_tab = "pk_blk_src" in scene
        dev = origin.device
        if self.inst_tab:
            self.src = scene["pk_blk_src"].to(torch.int64)
            self.inst = scene["pk_blk_inst"].to(torch.int64)
        else:
            self.src = torch.arange(self.m1e, device=dev)
            self.inst = torch.full((self.m1e,), -1, dtype=torch.int64,
                                   device=dev)
        self.inv = scene.get("pk_inst_inv")
        self.velo = scene.get("pk_inst_velo") if time is not None else None
        self.l2lo, self.l2hi = _padded(scene["pk_l2box"])
        self.o, self.d, self.t_max, self.time = origin, direction, t_max, time
        self.amask, self.prune = amask, prune
        self.budget = 1 << (26 if origin.is_cuda else 20)
        self.cg = torch.arange(self.g, device=dev)

    def fold(self, best, ray, e):
        """Visit the pairs (ray [P], expanded L1 e [P])."""
        g, k2, dev = self.g, self.k2, self.o.device
        pchunk = max(1, self.budget // (8 * g))
        qchunk = max(1, self.budget // (8 * k2))
        for p0 in range(0, ray.shape[0], pchunk):
            r, ee = ray[p0:p0 + pchunk], e[p0:p0 + pchunk]
            tm = self.time[r] if self.time is not None else None
            if self.inst_tab:
                ol, dl = instance_rays(self.inv, self.inst[ee], self.o[r],
                                       self.d[r], self.velo, tm)
            else:
                ol, dl = self.o[r], self.d[r]
            child = self.l1_base[self.src[ee]][:, None] + self.cg[None]
            if self.prune:
                profile.count("host_syncs")
                pi, ci = torch.nonzero(_enters(
                    self.l2lo[child], self.l2hi[child], ol[:, None],
                    dl[:, None], self.t_max[r][:, None])).unbind(1)
            else:
                pi = torch.arange(r.shape[0], device=dev).repeat_interleave(g)
                ci = self.cg.repeat(r.shape[0])
            for q0 in range(0, pi.shape[0], qchunk):
                qp, qc = pi[q0:q0 + qchunk], ci[q0:q0 + qchunk]
                rr = r[qp]
                ch = child[qp, qc]
                t, ok, u, v = _moller_trumbore(
                    ol[qp], dl[qp], self.tri[ch], self.t_max[rr],
                    tm[qp] if tm is not None else None)
                best.update(rr, (ee[qp] * g + qc) * k2, t, ok, u, v,
                            self.mask[ch] if self.amask else None)


def _plain_slots_general(scene, origin, direction, t_max, prune, amask,
                         time):
    """_plain_slots for instanced and / or moving tables: per (ray,
    expanded L1) pair the ray goes to the L1's source space, then per
    child of the physical L1 the triangles are tested there."""
    folder = _PairFolder(scene, origin, direction, t_max, time, amask, prune)
    l1lo, l1hi = _padded(scene["pk_l1box"])
    m1e = folder.m1e
    dev = origin.device
    n = origin.shape[0]
    best = PlainBest(n, dev, amask)
    rchunk = max(1, folder.budget // (4 * max(1, m1e)))
    for r0 in range(0, n, rchunk):
        o_c, d_c = origin[r0:r0 + rchunk], direction[r0:r0 + rchunk]
        if prune:
            profile.count("host_syncs")
            ray, e = torch.nonzero(_enters(
                l1lo[None], l1hi[None], o_c[:, None], d_c[:, None],
                t_max[r0:r0 + rchunk, None])).unbind(1)
        else:
            nr = o_c.shape[0]
            ray = torch.arange(nr, device=dev).repeat_interleave(m1e)
            e = torch.arange(m1e, device=dev).repeat(nr)
        folder.fold(best, ray + r0, e)
    return best.result()


def slab_entries(box, origin, inv, bound):
    """The kernel's slab entry (csrc/trace_common.cuh::slab_entry) of every
    box [M, 8] for every ray (origin, inv = 1 / guarded direction [R, 3]),
    clipped to [SHADOW_EPS, bound [R]]: [R, M], BIG_F32 where the ray does
    not enter the box.  Same float32 operations in the same order, so the
    entries and their order are the kernel's bit for bit."""
    lo, hi = box[None, :, 0:3], box[None, :, 4:7]
    o, iv = origin[:, None, :], inv[:, None, :]
    u0 = (lo - o) * iv
    u1 = (hi - o) * iv
    near, far = torch.fmin(u0, u1), torch.fmax(u0, u1)
    tn = torch.fmax(torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                               near[..., 2]),
                    torch.tensor(SHADOW_EPS, dtype=torch.float32))
    tf = torch.fmin(torch.fmin(torch.fmin(far[..., 0], far[..., 1]),
                               far[..., 2]), bound[:, None])
    return torch.where(tn <= tf * WIDEN, tn, BIG_F32)


# ---------------------------------------------------------------------------
# CUDA kernel: build + launch
# ---------------------------------------------------------------------------

_lib = None


def build_kernel() -> float:
    """Compile csrc/trace2.cu (if not built yet) and load it.  Returns the
    seconds spent.  The library is cached in _build/ by content hash."""
    global _lib
    if _lib is not None:
        return 0.0
    _lib = bind(cubuild.load("trace2"))
    return profile.counters()["kernels.trace2_s"]


def bind(lib):
    """Declare trace2_launch's (and trace2_occupancy's) C signature on a
    loaded library (the CUDA build or cubuild.host_library's host
    build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.trace2_launch.restype = I
    lib.trace2_launch.argtypes = [P, P, P, I, P, I, P, I, P, P, P, P, P, P,
                                  I, I, I, I, P, P, P, P, P, I, I,
                                  P, P, P, P, P, P]
    lib.trace2_occupancy.restype = I
    lib.trace2_occupancy.argtypes = [I, I, I, P]
    return lib


STAGE_MAX_BYTES = 16384   # group_walk.cuh's: coarse tables staged up to this


def staged_bytes(scene):
    """Bytes of shared memory a group-walk launch (K1's or K2's) on these
    tables stages: the coarse union boxes when they fit in
    STAGE_MAX_BYTES, else 0."""
    b = scene["pk_cbox"].shape[0] * 32
    return b if b <= STAGE_MAX_BYTES else 0


def occupancy(mode, window=False, smem=0, lib=None):
    """Blocks of 128 threads per SM of a mode's group kernel with `smem`
    bytes of staged coarse table (window=True: its window kernel), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; mode is a MODES name."""
    any_hit, amask, inst, motion = _MODE_BITS[mode]
    out = ctypes.c_int(0)
    rc = (lib or _lib).trace2_occupancy(amask + 3 * inst + 6 * motion,
                                        int(window), int(smem),
                                        ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"trace2_occupancy failed (cudaError {rc})")
    return out.value


def check_tensor(kernel, name, x, dtype, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {x.dtype} on {x.device}")


def mode_name(any_hit, amask, inst=False, motion=False):
    """The launch-count key of a mode: closest / any_hit / amask1 / amask2,
    prefixed inst_ for instanced tables and motion_ for a moving scene."""
    base = "any_hit" if any_hit else ("closest", "amask1", "amask2")[amask]
    return ("inst_" if inst else "") + ("motion_" if motion else "") + base


def _ptr(x):
    return None if x is None else x.data_ptr()


def schedule_names(window=1, pops=1, mode=None):
    """The launch-count keys of a schedule: "window2" / "window4" (and,
    given the mode, "window<w>_<mode>"), or "pops<p>" (p > 1) for the
    walk's order."""
    names = []
    if window > 1:
        names.append(f"window{window}")
        if mode is not None:
            names.append(f"window{window}_{mode}")
    elif pops > 1:
        names.append(f"pops{pops}")
    return names


def _launch_kernel(scene, origin, direction, t_max, any_hit, counters,
                   amask, time=None, host_lib=None, window=1, pops=1):
    """Launch the kernel on CUDA tensors.  host_lib: a cubuild.host_library
    build, run on CPU tensors instead (the kernel's logic where there is
    no GPU; not counted as a launch).
    Returns (t, key, extra): extra is None, or a dict of the counter
    outputs."""
    if host_lib is None:
        build_kernel()
    dev = origin.device
    n = origin.shape[0]
    tri, l2box = scene["pk_tri"], scene["pk_l2box"]
    l1box, l1_base = scene["pk_l1box"], scene["pk_l1_base"]
    if "pk_cbox" not in scene:
        raise ValueError("trace2: the tables lack the coarse front (pk_cbox, "
                         "pk_cmem, pk_cgrp of build_tri_blocks2 / "
                         "build_tri_blocks2_inst)")
    coarse, cmem, cgrp = scene["pk_cbox"], scene["pk_cmem"], scene["pk_cgrp"]
    inst = "pk_blk_src" in scene
    checks = [("origin", origin, torch.float32),
              ("direction", direction, torch.float32),
              ("t_max", t_max, torch.float32),
              ("pk_tri", tri, torch.float32),
              ("pk_l2box", l2box, torch.float32),
              ("pk_l1box", l1box, torch.float32),
              ("pk_cbox", coarse, torch.float32),
              ("pk_cmem", cmem, torch.int32),
              ("pk_cgrp", cgrp, torch.int32),
              ("pk_l1_base", l1_base, torch.int32)]
    mask = src = binst = inv = velo = None
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
            velo = scene["pk_inst_velo"]
            checks.append(("pk_inst_velo", velo, torch.float32))
    if time is not None:
        checks.append(("time", time, torch.float32))
    for name, x, dt in checks:
        check_tensor("trace2", name, x, dt, dev)
    m1, m2, m1p = l1box.shape[0], l2box.shape[0], l1_base.shape[0]
    if (origin.shape != (n, 3) or direction.shape != (n, 3)
            or tri.shape[1:] != (12,) or l2box.shape[1:] != (8,)
            or l1box.shape[1:] != (8,) or (not inst and m1p != m1)
            or coarse.ndim != 2 or coarse.shape[1] != 8
            or cmem.shape != (coarse.shape[0], COARSE_G)
            or cgrp.shape != (m1,)
            or m2 % m1p or tri.shape[0] % m2
            or (time is not None and time.shape != (n,))
            or (amask and mask.shape != (tri.shape[0], 8))
            or (inst and (src.shape != (m1,) or binst.shape != (m1,)
                          or inv.ndim != 2 or inv.shape[1] != 12
                          or (velo is not None
                              and velo.shape != (inv.shape[0], 3))))):
        raise ValueError("trace2: ray or table shapes do not match the "
                         "build_tri_blocks2 / build_tri_blocks2_inst layout")
    k2 = tri.shape[0] // m2
    g = m2 // m1p
    if g > 64:
        raise ValueError(f"trace2: at most 64 child blocks per L1, got {g}")
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    out_blk = (torch.empty((n,), dtype=torch.int32, device=dev) if inst
               else None)
    cnt = touched = None
    if counters:
        cnt = torch.zeros((n, 5), dtype=torch.int32, device=dev)
        touched = torch.zeros((m1 + m2,), dtype=torch.uint8, device=dev)
    stream = None
    if host_lib is None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
    rc = (host_lib or _lib).trace2_launch(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), n,
        l1box.data_ptr(), m1, coarse.data_ptr(), coarse.shape[0],
        cmem.data_ptr(), cgrp.data_ptr(), l1_base.data_ptr(),
        l2box.data_ptr(), tri.data_ptr(), _ptr(mask), k2, g,
        int(bool(any_hit)), int(amask), _ptr(src), _ptr(binst), _ptr(inv),
        _ptr(velo), _ptr(time), int(window), int(pops), out_t.data_ptr(),
        out_slot.data_ptr(), _ptr(out_blk), _ptr(cnt), _ptr(touched), stream)
    if rc != 0:
        raise RuntimeError(f"trace2 kernel launch failed (cudaError {rc})")
    if host_lib is None:
        tri_intersect2.launches += 1
        mode = mode_name(any_hit, amask, inst, time is not None)
        tri_intersect2.launches_by_mode[mode] += 1
        by_sched = tri_intersect2.launches_by_schedule
        for k in schedule_names(window, pops, mode):
            by_sched[k] = by_sched.get(k, 0) + 1
    extra = None
    if counters:
        extra = dict(counters=cnt, l1_touched=touched[:m1].bool(),
                     leaf_touched=touched[m1:].bool())
    slot = out_slot.to(torch.int64)
    if inst:    # (expanded L1, offset) -> the plain version's key
        slot = torch.where(slot >= 0,
                           out_blk.to(torch.int64) * (g * k2) + slot, slot)
    return out_t, slot, extra


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def _ray_args(origin, direction, t_max, time):
    n = origin.shape[0]
    origin = origin.to(torch.float32).contiguous()
    direction = direction.to(torch.float32).contiguous()
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=origin.device),
                               (n,)).contiguous()
    if time is not None:
        time = torch.broadcast_to(torch.as_tensor(
            time, dtype=torch.float32, device=origin.device), (n,)).contiguous()
    return origin, direction, t_max, time


def tri_intersect2(scene, origin, direction, t_max, any_hit: bool = False,
                   counters: bool = False, amask: int = 0, time=None,
                   window: int | None = None, pops: int = 1):
    """Closest (or any) hit of a ray batch against the two-level tables.

    origin/direction [N,3] f32, t_max [N] f32 (or a scalar), time [N] f32
    per-ray shutter time for tables built with velocities (None = static).
    Returns dict(t, tri, inst, valid); amask=2 adds "solid" (module
    docstring).  counters=True (CUDA only) adds "counters", per ray int32
    [N,5] (top-level refills, L1 visits, leaf blocks tested, mask lookups,
    top-level slab tests: coarse unions + L1 entries),
    and "l1_touched" [M1] / "leaf_touched" [M2] bool, the (expanded) L1s
    and the physical child blocks any ray visited.

    window (None = 1, or 2 / 4: the resident-window drain) and pops
    (children per drain step) are schedules: they change the kernel's
    order of work, never its result, and the plain version ignores them.
    Values outside them are refused (_check_schedule)."""
    _check_mode(scene, any_hit, amask, time)
    window = _check_schedule(window, pops)
    origin, direction, t_max, time = _ray_args(origin, direction, t_max, time)
    extra = None
    if origin.is_cuda:
        with profile.span("k1.launch"):
            t, slot, extra = _launch_kernel(
                scene, origin, direction, t_max, any_hit, counters, amask,
                time, window=window, pops=pops)
    else:
        if counters:
            raise ValueError("counters come from the CUDA kernel only")
        t, slot = _plain_slots(scene, origin, direction, t_max, True, amask,
                               time)
    res = _result(scene, t, slot, amask)
    if extra is not None:
        res.update(extra)
    return res


_MODE_BITS = {mode_name(a, m, i, t): (a, m, i, t) for i, t, a, m in (
    (0, 0, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), (0, 0, 0, 2),
    (1, 0, 0, 0), (1, 0, 1, 0), (1, 0, 0, 1), (1, 0, 0, 2),
    (0, 1, 0, 0), (0, 1, 1, 0), (1, 1, 0, 0), (1, 1, 1, 0))}
MODES = tuple(_MODE_BITS)
tri_intersect2.launches = 0           # kernel launches, all modes
tri_intersect2.launches_by_mode = {m: 0 for m in MODES}
tri_intersect2.launches_by_schedule = {}   # schedule_names() -> launches


def reset_launches():
    """Set the kernel's launch counts (total, per mode, per schedule) to 0."""
    tri_intersect2.launches = 0
    for k in tri_intersect2.launches_by_mode:
        tri_intersect2.launches_by_mode[k] = 0
    tri_intersect2.launches_by_schedule.clear()


def _check_mode(scene, any_hit, amask, time=None):
    if amask not in (0, 1, 2):
        raise ValueError(f"amask must be 0, 1 or 2, got {amask!r}")
    if amask and any_hit:
        # mode 1 filters a closest pass; mode 2 is its own predicate walk:
        # a plain any-hit would take mixed candidates for occluders
        raise ValueError("amask and any_hit are mutually exclusive")
    if amask and "pk_mask" not in scene:
        raise ValueError("amask needs tables built with tri_mask (pk_mask)")
    if amask and time is not None:
        raise ValueError("alpha masks and motion exclude each other")


def _check_schedule(window, pops):
    """Refuse a window outside {1, 2, 4} or pops < 1; returns the window
    (None -> 1)."""
    window = 1 if window is None else int(window)
    if window not in (1, 2, 4):
        raise ValueError(f"window must be 1, 2 or 4, got {window!r}")
    if int(pops) < 1:
        raise ValueError(f"pops must be >= 1, got {pops!r}")
    return window


def tri_intersect2_plain(scene, origin, direction, t_max,
                         any_hit: bool = False, prune: bool = True,
                         amask: int = 0, time=None,
                         window: int | None = None, pops: int = 1):
    """The plain version on any device (the kernel's oracle on the card;
    never called on the render path).  prune=False tests every slot of
    the table instead of the triangles of the entered child blocks.
    any_hit changes nothing here: the nearest hit is also an occluder.
    window and pops are checked and otherwise no-ops."""
    _check_mode(scene, any_hit, amask, time)
    _check_schedule(window, pops)
    origin, direction, t_max, time = _ray_args(origin, direction, t_max, time)
    t, key = _plain_slots(scene, origin, direction, t_max, prune, amask, time)
    return _result(scene, t, key, amask)


def child_boxes_hold_triangles(scene, tri_v) -> bool:
    """Table check: every vertex of every data slot's triangle (tri_v
    [T,3,3], the triangles the tables were built from; for instanced
    tables use it on world-only tables) lies in its child box, and every
    child with no data slot is a far-point box.  This is what makes
    culling by child box, in the kernel and in the plain version, unable
    to drop a hit."""
    box = scene["pk_l2box"]
    m2 = box.shape[0]
    s2t = scene["pk_slot2tri"].view(m2, -1)
    v = tri_v[torch.clamp(s2t, min=0).to(torch.int64)]     # [M2, K2, 3, 3]
    lo = box[:, None, None, 0:3]
    hi = box[:, None, None, 4:7]
    inside = ((v >= lo) & (v <= hi)).flatten(2).all(-1)
    empty = (s2t < 0).all(1)
    profile.count("host_syncs", 3)
    far = box[empty][:, [0, 1, 2, 4, 5, 6]] == 3e37
    return bool((inside | (s2t < 0)).all()) and bool(far.all())


def _result(scene, t, key, amask=0):
    """(t, key) per ray -> the dict(t, tri, inst, valid) contract, plus
    solid (key == -2) under amask=2.  For instanced tables the key is
    expanded L1 * (G * K2) + offset: the instance is the expanded L1's,
    the triangle the slot `offset` of its physical L1."""
    s2t = scene["pk_slot2tri"]
    valid = key >= 0
    kc = torch.clamp(key, min=0)
    if "pk_blk_src" in scene:
        per_l1 = s2t.shape[0] // scene["pk_l1_base"].shape[0]   # G * K2
        k2 = s2t.shape[0] // scene["pk_l2box"].shape[0]
        e = torch.clamp(kc // per_l1, max=scene["pk_blk_src"].shape[0] - 1)
        src = scene["pk_blk_src"][e].to(torch.int64)
        slot = scene["pk_l1_base"][src].to(torch.int64) * k2 + kc % per_l1
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
