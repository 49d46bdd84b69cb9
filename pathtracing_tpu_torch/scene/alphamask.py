"""Conservative per-triangle alpha micro-masks for in-kernel alpha tests
(counterpart of pathtracing_tpu/scene/alphamask.py; NumPy only).

A traversal kernel cannot afford a texture fetch per (ray, triangle)
candidate, but it can afford a per-triangle bitmask lookup at the
Moller-Trumbore (u, v): at build time each alpha-material triangle gets
an 8x8 grid of cells over its TEXTURE-SPACE uv bounding box (barycentric
cells shear badly for the diagonal uv layouts card foliage uses), each
cell classified CONSERVATIVELY against the material's alpha source:

  opaque      - every point of the cell has alpha > cutoff: a hit here
                is DEFINITELY solid
  transparent - every point has alpha <= cutoff: definitely pass-through
  mixed       - straddles the cutoff (or analysis impossible): the hit
                needs the exact texture test

Per triangle the tables carry MASK_ROWS = 7 words.  They are bit
patterns, so this package carries them as int32 (a float32 tensor that
holds NaN-patterned words is not safe through where/pad/arithmetic):

  words 0..2   two packed bf16 coefficients each: low half b_i, high
               half c_i of the affine cell map
               gx = b0 + b1*u + b2*v,  gy = c0 + c1*u + c2*v
               ((u, v) = Moller-Trumbore barycentrics; gx, gy in cells)
  words 3..4   opaque bits, cells 0..31 / 32..63 (cell = cv*8 + cu)
  words 5..6   mixed bits, same layout

The words are bit-equal to the float32 rows the reference package builds
for the same inputs.  The traversal (accel/trace2.py) then:
  * closest pass (amask=1): drops definitely-transparent candidates (the
    shade stage's exact test + restart handles mixed ones as before);
  * shadow pass (amask=2): a definitely-opaque hit nearer than every
    mixed hit occludes outright; otherwise the nearest MIXED hit is the
    restart chain's candidate.

Conservativeness makes the final image EXACT: a cell is only classified
opaque/transparent when the bilinear alpha over its (slightly inflated)
texture footprint is provably on one side of the cutoff - interval
bounds via min/max texel pyramids (bilinear interpolation is a convex
combination of texels, so the texel range over a covering set bounds
it).  The classifier uses the SAME bf16-rounded coefficients the kernel
reads and inflates each cell by a margin covering f32 evaluation-order
differences.  BLEND-mode materials are all mixed unless the cell's
alpha is provably 0 (never solid: u ~ U[0,1)) or provably 1.
"""
from __future__ import annotations

import numpy as np

from .textures import KIND_IMAGE, KIND_SOLID

CELLS = 8                     # 8x8 texture-space grid
MASK_ROWS = 7                 # mask words per triangle
_EPS = 1e-5                   # guard band around the cutoff (f32 bilinear
                              # rounding can cross an exact-equality edge)
_CELL_PAD = 0.05              # cell inflation, in cells: covers f32 vs
                              # f64 evaluation-order differences of the
                              # affine map AND the (small) disagreement
                              # between the kernel's Moller-Trumbore
                              # (u, v) and the shade stage's recomputed
                              # barycentrics — the exact test that must
                              # agree with the classification runs on
                              # the latter


# ---------------------------------------------------------------------------
# Anisotropic min/max pyramids (2D range bounds in O(1) per query)
# ---------------------------------------------------------------------------

class _Pyramid:
    """Min & max tables over all (level_y, level_x) halvings of a plane.

    Cell (ly, lx)[j, i] bounds texels [j*2^ly, (j+1)*2^ly) x
    [i*2^lx, (i+1)*2^lx); ragged edges pad with the op's neutral, so a
    query that covers padding is a no-op on the bound (still a superset
    of the real texels asked for => conservative)."""

    def __init__(self, plane: np.ndarray):
        plane = np.asarray(plane, np.float32)
        self.h, self.w = plane.shape
        self.ly_max = int(np.ceil(np.log2(self.h))) if self.h > 1 else 0
        self.lx_max = int(np.ceil(np.log2(self.w))) if self.w > 1 else 0

        def halve(a, axis, neutral, op):
            if a.shape[axis] % 2:
                pad = [(0, 0), (0, 0)]
                pad[axis] = (0, 1)
                a = np.pad(a, pad, constant_values=neutral)
            sl0 = [slice(None)] * 2
            sl1 = [slice(None)] * 2
            sl0[axis] = slice(0, None, 2)
            sl1[axis] = slice(1, None, 2)
            return op(a[tuple(sl0)], a[tuple(sl1)])

        self.tmin = {}
        self.tmax = {}
        row_min = {0: plane}
        row_max = {0: plane}
        for ly in range(1, self.ly_max + 1):
            row_min[ly] = halve(row_min[ly - 1], 0, np.inf, np.minimum)
            row_max[ly] = halve(row_max[ly - 1], 0, -np.inf, np.maximum)
        for ly in range(self.ly_max + 1):
            a, b = row_min[ly], row_max[ly]
            self.tmin[(ly, 0)] = a
            self.tmax[(ly, 0)] = b
            for lx in range(1, self.lx_max + 1):
                a = halve(a, 1, np.inf, np.minimum)
                b = halve(b, 1, -np.inf, np.maximum)
                self.tmin[(ly, lx)] = a
                self.tmax[(ly, lx)] = b

    def _axis_segments(self, a0, a1, n):
        """Wrap a texel range [a0, a1] (repeat) into up
        to two in-bounds segments; ranges >= n collapse to the whole
        axis.  Returns (seg0, seg1, has2) with segs as (lo, hi)."""
        span = a1 - a0 + 1
        whole = span >= n
        m0 = np.mod(a0, n)
        m1 = np.mod(a1, n)
        wrapped = (m1 < m0) & ~whole
        s0 = (np.where(whole, 0, m0),
              np.where(whole, n - 1, np.where(wrapped, n - 1, m1)))
        s1 = (np.zeros_like(m0), np.where(wrapped, m1, 0))
        return s0, s1, wrapped

    def query(self, x0, x1, y0, y1, bits=None):
        """Conservative (min, max) of the plane over wrapped texel ranges
        [x0,x1] x [y0,y1]; all args int arrays of one shape.  `bits`
        sets query granularity (2^bits aligned cells per axis): finer =
        tighter bounds, more gathers — auto-picked from the batch size
        when None."""
        if bits is None:
            bits = 4 if np.size(x0) <= (1 << 20) else _CPA_BITS
        cpa = 1 << bits
        sx0, sx1, wx = self._axis_segments(np.asarray(x0), np.asarray(x1),
                                           self.w)
        sy0, sy1, wy = self._axis_segments(np.asarray(y0), np.asarray(y1),
                                           self.h)
        lo = np.full(np.shape(x0), np.inf, np.float32)
        hi = np.full(np.shape(x0), -np.inf, np.float32)

        def seg_query(xs, ys, active):
            # query at a level fine enough that aligned cells cover the
            # range with <= _CPA cells per axis: over-coverage is then
            # <= 2 * 2^l <= span/2, keeping the bounds tight (a plain
            # two-aligned-cell query over-covered by up to ~4x, which
            # classified nearly every foliage cell "mixed")
            nonlocal lo, hi
            xa, xb = xs
            ya, yb = ys
            lx = np.maximum(_level_for(xb - xa + 1, self.lx_max)
                            - bits, 0)
            ly = np.maximum(_level_for(yb - ya + 1, self.ly_max)
                            - bits, 0)
            for lvl_x in np.unique(lx[active]) if active.any() else []:
                for lvl_y in np.unique(ly[active & (lx == lvl_x)]):
                    m = active & (lx == lvl_x) & (ly == lvl_y)
                    tmin = self.tmin[(int(lvl_y), int(lvl_x))]
                    tmax = self.tmax[(int(lvl_y), int(lvl_x))]
                    cx0 = xa[m] >> lvl_x
                    cx1 = np.minimum(xb[m] >> lvl_x, tmin.shape[1] - 1)
                    cy0 = ya[m] >> lvl_y
                    cy1 = np.minimum(yb[m] >> lvl_y, tmin.shape[0] - 1)
                    l = np.full(cx0.shape, np.inf, np.float32)
                    h = np.full(cx0.shape, -np.inf, np.float32)
                    for oy in range(cpa + 1):
                        cy = np.minimum(cy0 + oy, cy1)
                        for ox in range(cpa + 1):
                            cx = np.minimum(cx0 + ox, cx1)
                            l = np.minimum(l, tmin[cy, cx])
                            h = np.maximum(h, tmax[cy, cx])
                    lo[m] = np.minimum(lo[m], l)
                    hi[m] = np.maximum(hi[m], h)

        ones = np.ones(np.shape(x0), bool)
        seg_query(sx0, sy0, ones)
        seg_query(sx1, sy0, wx)
        seg_query(sx0, sy1, wy)
        seg_query(sx1, sy1, wx & wy)
        return lo, hi


_CPA_BITS = 3                 # query granularity: up to 2^3 = 8 aligned
_CPA = 1 << _CPA_BITS         # pyramid cells per axis per range query


def _level_for(span, lmax):
    """Smallest level l with 2^l >= span: the range then touches at most
    two aligned level-l cells."""
    span = np.maximum(np.asarray(span, np.int64), 1)
    l = np.zeros_like(span)
    while True:
        need = (np.int64(1) << l) < span
        if not need.any():
            break
        l = l + need.astype(np.int64)
    return np.minimum(l, lmax)


# ---------------------------------------------------------------------------
# bf16 packing helpers (the kernel reads bf16 pairs from one f32 word)
# ---------------------------------------------------------------------------

def _to_bf16(x):
    """Round-to-nearest-even f32 -> bf16, returned as f32 with a zero
    low half (the exact value the kernel reconstructs)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _pack_pair(b, c):
    """One f32 word per element: low 16 bits = bf16(b), high = bf16(c)."""
    bb = _to_bf16(b).view(np.uint32) >> 16
    cc = _to_bf16(c).view(np.uint32) & np.uint32(0xFFFF0000)
    return (bb | cc).view(np.float32)


# ---------------------------------------------------------------------------
# Per-triangle classification
# ---------------------------------------------------------------------------

def _alpha_source(pool, mat_tex_row):
    """Resolve a material's alpha source exactly as the shade stage does
    (integrators/path.py alpha block, scene/intersect.py _occluded):
    a dedicated alpha texture's RED channel (x colorScale.r) when
    mat_tex[4] >= 0, else the base texture's ALPHA channel (1.0 when the
    image has < 4 channels).

    Returns ("plane", np[H,W]) | ("const", a) | (None, None) when
    unanalyzable (-> all cells mixed)."""
    atex = int(mat_tex_row[4])
    btex = int(mat_tex_row[0])
    if atex >= 0:
        if atex >= len(pool._info_i):
            return None, None
        info = pool._info_i[atex]
        if info[0] == KIND_SOLID:
            return "const", float(pool._info_f[atex][5]
                                  * pool._info_f[atex][0])
        if info[0] == KIND_IMAGE:
            h, w = info[3], info[2]
            plane = pool._texels[_image_index(pool, atex)]
            return "plane", (plane[:, 0].reshape(h, w)
                             * np.float32(pool._info_f[atex][0]))
        return None, None
    if btex < 0 or btex >= len(pool._info_i):
        # no texture: alpha == 1 everywhere
        return "const", 1.0
    info = pool._info_i[btex]
    kind, channels = info[0], info[4]
    if kind == KIND_IMAGE:
        if channels < 4:
            return "const", 1.0                   # alpha defaults to 1
        h, w = info[3], info[2]
        plane = pool._texels[_image_index(pool, btex)]
        return "plane", plane[:, 3].reshape(h, w)
    if kind == KIND_SOLID:
        return "const", 1.0                       # solid alpha == 1
    return None, None                             # checker/uv: mixed


def _image_index(pool, tid):
    """Index into pool._texels for image texture `tid` (only images
    append texel planes)."""
    k = 0
    for i in range(tid):
        if pool._info_i[i][0] == KIND_IMAGE:
            k += 1
    return k


def _classify(a_lo, a_hi, mode, cutoff):
    """(definitely_solid, possibly_solid) from conservative alpha bounds.

    MASK (2): solid <=> a > cutoff (as integrators/path.py tests it).
    BLEND (1): solid <=> u < a with u ~ U[0,1): provably always solid iff
    a >= 1, never iff a <= 0."""
    a_lo = np.asarray(a_lo)
    a_hi = np.asarray(a_hi)
    if mode == 2:
        return (a_lo > cutoff + _EPS), (a_hi > cutoff - _EPS)
    if mode == 1:
        return (a_lo >= 1.0 - 1e-7), (a_hi > _EPS)
    # OPAQUE material in an alpha table shouldn't happen; always solid
    ones = np.ones(a_lo.shape, bool)
    return ones, ones


def build_tri_alpha_masks(uvs, mat_ids, pool, mat_modes, mat_cutoffs,
                          mat_tex):
    """[n, MASK_ROWS] int32 mask words for alpha triangles.

    uvs [n,3,2] per-vertex texture coords (vertex order == the packed
    (v0, e1, e2) table order — MT's u weights vertex 1, v vertex 2);
    mat_ids [n]; pool: the host TexturePool; mat_modes / mat_cutoffs /
    mat_tex: per-material alpha config (lists or arrays)."""
    n = len(uvs)
    uvs = np.asarray(uvs, np.float32).reshape(n, 3, 2)
    mat_ids = np.asarray(mat_ids, np.int64)
    out = np.zeros((n, MASK_ROWS), np.float32)
    words = np.zeros((n, 4), np.uint32)

    # affine cell map from barycentrics, per tri: tex = uv0 + u*e1 + v*e2,
    # g = (tex - lo) * CELLS / span  =>  b0 = (uv0-lo)*s, b1 = e1*s, ...
    e1 = uvs[:, 1] - uvs[:, 0]
    e2 = uvs[:, 2] - uvs[:, 0]
    lo = uvs.min(1)
    span = np.maximum(uvs.max(1) - lo, 1e-6)
    s = CELLS / span
    b = np.stack([(uvs[:, 0, 0] - lo[:, 0]) * s[:, 0],
                  e1[:, 0] * s[:, 0], e2[:, 0] * s[:, 0]], 1)   # [n,3]
    c = np.stack([(uvs[:, 0, 1] - lo[:, 1]) * s[:, 1],
                  e1[:, 1] * s[:, 1], e2[:, 1] * s[:, 1]], 1)
    # the kernel reads bf16: classify with the SAME rounded map
    bq = _to_bf16(b)
    cq = _to_bf16(c)
    for i in range(3):
        out[:, i] = _pack_pair(b[:, i], c[:, i])

    ci = np.arange(CELLS)
    gx0, gy0 = np.meshgrid(ci, ci)                  # [8,8]: gx minor
    gx0 = gx0.reshape(-1)                           # cell = gy*8 + gx
    gy0 = gy0.reshape(-1)

    pyramids = {}
    for mid in np.unique(mat_ids):
        sel = np.nonzero(mat_ids == mid)[0]
        if mid < 0 or mid >= len(mat_modes):
            words[sel, 2:4] = 0xFFFFFFFF            # all mixed
            continue
        mode = int(mat_modes[mid])
        cutoff = float(mat_cutoffs[mid])
        kind, src = _alpha_source(pool, mat_tex[mid])
        if kind is None:
            words[sel, 2:4] = 0xFFFFFFFF
            continue
        if kind == "const":
            solid_lo, solid_hi = _classify(src, src, mode, cutoff)
            if solid_lo:
                words[sel, 0:2] = 0xFFFFFFFF
            elif solid_hi:
                words[sel, 2:4] = 0xFFFFFFFF
            continue
        key = id(src)
        if key not in pyramids:
            pyramids[key] = _Pyramid(src)
        pyr = pyramids[key]

        # dedup identical (uv triple) rows — card foliage repeats a
        # couple of layouts tens of thousands of times
        flat = np.ascontiguousarray(
            np.concatenate([uvs[sel].reshape(-1, 6)], 1))
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        u_sel = sel[np.unique(inv, return_index=True)[1]]
        U = len(uniq)
        # invert the (rounded) cell map per unique tri: tex coords of
        # cell column/row boundaries.  g = b0 + b1*u + b2*v and
        # tex_x = uv0x + u*e1x + v*e2x are both affine in (u, v); the
        # cell's tex-space footprint bbox is attained at (u, v) corners
        # of the valid domain... instead, use the direct relation
        # tex_x = lo_x + (g_x - b0 + b0) ... — since the rounded map is
        # itself affine with the SAME (u, v) arguments, express tex
        # bounds of {g_x in [i, i+1]} through the exact map composed
        # with the rounded map's preimage.  Conservative shortcut: the
        # exact map satisfies tex_x = lo_x + g_x^exact * span_x/CELLS;
        # |g_x^exact - g_x^bf16| <= d_x (bounded below over the valid
        # barycentric triangle u, v >= 0, u+v <= 1), so
        # {g_x in [i, i+1]}  =>  tex_x in
        #   lo_x + [i - d_x, i + 1 + d_x] * span_x / CELLS.
        bqs = bq[u_sel]
        cqs = cq[u_sel]
        bs = b[u_sel]
        cs = c[u_sel]
        # max |delta0 + delta1*u + delta2*v| over the triangle = max at
        # a corner: (0,0), (1,0), (0,1)
        dbx = np.abs(bqs - bs)
        dby = np.abs(cqs - cs)
        d_x = np.maximum(dbx[:, 0],
                         np.maximum(dbx[:, 0] + dbx[:, 1],
                                    dbx[:, 0] + dbx[:, 2])) + _CELL_PAD
        d_y = np.maximum(dby[:, 0],
                         np.maximum(dby[:, 0] + dby[:, 1],
                                    dby[:, 0] + dby[:, 2])) + _CELL_PAD
        lo_u = lo[u_sel]
        sp_u = span[u_sel]
        tx0 = lo_u[:, None, 0] + (gx0[None, :] - d_x[:, None]) \
            * sp_u[:, None, 0] / CELLS                        # [U,64]
        tx1 = lo_u[:, None, 0] + (gx0[None, :] + 1 + d_x[:, None]) \
            * sp_u[:, None, 0] / CELLS
        ty0 = lo_u[:, None, 1] + (gy0[None, :] - d_y[:, None]) \
            * sp_u[:, None, 1] / CELLS
        ty1 = lo_u[:, None, 1] + (gy0[None, :] + 1 + d_y[:, None]) \
            * sp_u[:, None, 1] / CELLS
        # continuous texel coords (bilinear samples at u*W - 0.5),
        # inflated to the touched texel range
        x_lo = np.floor(tx0 * pyr.w - 0.5).astype(np.int64)
        x_hi = np.floor(tx1 * pyr.w - 0.5).astype(np.int64) + 1
        y_lo = np.floor(ty0 * pyr.h - 0.5).astype(np.int64)
        y_hi = np.floor(ty1 * pyr.h - 0.5).astype(np.int64) + 1
        a_lo, a_hi = pyr.query(x_lo, x_hi, y_lo, y_hi)        # [U,64]
        solid_lo, solid_hi = _classify(a_lo, a_hi, mode, cutoff)
        opaque = solid_lo
        mixed = solid_hi & ~solid_lo
        w = np.zeros((U, 4), np.uint32)
        bit = np.uint32(1) << (np.arange(64, dtype=np.uint32) & 31)
        for ws in range(2):
            cells = slice(ws * 32, ws * 32 + 32)
            w[:, ws] = (opaque[:, cells]
                        * bit[None, cells]).sum(1, dtype=np.uint32)
            w[:, 2 + ws] = (mixed[:, cells]
                            * bit[None, cells]).sum(1, dtype=np.uint32)
        words[sel] = w[inv]
    out[:, 3:7] = words.view(np.float32)
    return out.view(np.int32)
