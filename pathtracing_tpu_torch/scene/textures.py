"""Texture pool: host-side packing and batched evaluation (counterpart of
pathtracing_tpu/scene/textures.py).

A flat texel pool plus a small typed table, so one gather-based function
evaluates any number of textures for a whole lane batch at once.

Layout:
  tex_texels [NT, 4] f32  RGBA texel pool, linear space, row-major per image
  tex_info_i [K, 6] i32   kind, offset, width, height, channels, child packed
  tex_info_f [K, 8] f32   colorScale rgb, inv_scale u/v (checker), solid rgb

Kinds: 0 image (bilinear, repeat wrap), 1 checker (two child textures),
2 uv debug, 3 solid color.  Texture id -1 = "no texture": callers fall
back to material constants.  Every table index is clipped explicitly (a
CUDA gather faults where the reference's backend clamps).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import fma
from ..utils.profile import count

KIND_IMAGE = 0
KIND_CHECKER = 1
KIND_UV = 2
KIND_SOLID = 3


def _srgb_to_linear_np(s):
    s = np.clip(s, 0.0, 1.0)
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


class TexturePool:
    """Host-side accumulation of textures; pack() produces the NumPy
    arrays the builder uploads."""

    def __init__(self):
        self._texels = []          # list of [H*W,4] float32
        self._info_i = []
        self._info_f = []
        self._offset = 0

    def __len__(self):
        return len(self._info_i)

    @classmethod
    def from_packed(cls, texels, info_i, info_f):
        """The pool that pack()s to these arrays (a scene carried across
        as arrays gets its host pool back for the alpha-mask build)."""
        pool = cls()
        texels = np.asarray(texels, np.float32)
        info_i = np.asarray(info_i, np.int32)
        info_f = np.asarray(info_f, np.float32)
        for ii, ff in zip(info_i, info_f):
            pool._info_i.append([int(x) for x in ii])
            pool._info_f.append([float(x) for x in ff])
            if ii[0] == KIND_IMAGE:
                count = int(ii[2]) * int(ii[3])
                pool._texels.append(texels[int(ii[1]):int(ii[1]) + count])
                pool._offset = int(ii[1]) + count
        return pool

    def add_image(self, img: np.ndarray, srgb: bool = False,
                  color_scale=(1.0, 1.0, 1.0)) -> int:
        """img: [H,W,C] uint8 or float; C in {1,3,4}.  srgb converts the
        RGB channels to linear at pack time."""
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        rgba = np.ones((h, w, 4), np.float32)
        if c == 1:
            rgba[..., :3] = img
        else:
            rgba[..., :c] = img[..., :4]
        if srgb:
            rgba[..., :3] = _srgb_to_linear_np(rgba[..., :3])
        tid = len(self._info_i)
        self._texels.append(rgba.reshape(-1, 4))
        self._info_i.append([KIND_IMAGE, self._offset, w, h, c, 0])
        cs = np.asarray(color_scale, np.float32)
        self._info_f.append([cs[0], cs[1], cs[2], 0, 0, 0, 0, 0])
        self._offset += h * w
        return tid

    def add_solid(self, color, color_scale=(1.0, 1.0, 1.0)) -> int:
        tid = len(self._info_i)
        self._info_i.append([KIND_SOLID, 0, 0, 0, 3, 0])
        c = np.asarray(color, np.float32)
        cs = np.asarray(color_scale, np.float32)
        self._info_f.append([cs[0], cs[1], cs[2], 0, 0, c[0], c[1], c[2]])
        return tid

    def add_checker(self, tex_a: int, tex_b: int, uv_scale=(1.0, 1.0),
                    color_scale=(1.0, 1.0, 1.0)) -> int:
        tid = len(self._info_i)
        child = (tex_a & 0xFFFF) | ((tex_b & 0xFFFF) << 16)
        self._info_i.append([KIND_CHECKER, 0, 0, 0, 3, child])
        cs = np.asarray(color_scale, np.float32)
        self._info_f.append([cs[0], cs[1], cs[2],
                             1.0 / uv_scale[0], 1.0 / uv_scale[1], 0, 0, 0])
        return tid

    def add_uv_debug(self) -> int:
        tid = len(self._info_i)
        self._info_i.append([KIND_UV, 0, 0, 0, 3, 0])
        self._info_f.append([1, 1, 1, 0, 0, 0, 0, 0])
        return tid

    def pack(self):
        if self._texels:
            texels = np.concatenate(self._texels, axis=0)
        else:
            texels = np.ones((1, 4), np.float32)
        if not self._info_i:
            info_i = np.zeros((1, 6), np.int32)
            info_f = np.zeros((1, 8), np.float32)
        else:
            info_i = np.asarray(self._info_i, np.int32)
            info_f = np.asarray(self._info_f, np.float32)
        return dict(tex_texels=texels, tex_info_i=info_i, tex_info_f=info_f)


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------

def _fetch_rgba(tex, offset, width, height, x, y):
    """Repeat-wrap texel fetch.  torch.remainder is a floor-mod, so
    negative texel coordinates wrap like the reference's."""
    xw = torch.remainder(x, width)
    yw = torch.remainder(y, height)
    texels = tex["tex_texels"]
    idx = torch.clamp(offset + yw * width + xw, 0, texels.shape[0] - 1)
    return texels[idx]


def _bilinear(tex, offset, width, height, uv):
    """Bilinear fetch at u*W-0.5.  Returns RGBA."""
    # u*W - 0.5 rounded once, as the reference's compiled code fuses it: at
    # u*W in the thousands a second rounding moves the weights by 1e-4
    count("host_syncs")         # a copy to the device the host waits for
    half = uv.new_tensor(-0.5)
    x = fma(uv[..., 0], width.to(torch.float32), half)
    y = fma(uv[..., 1], height.to(torch.float32), half)
    xf = torch.floor(x)
    yf = torch.floor(y)
    xi = xf.to(torch.int64)
    yi = yf.to(torch.int64)
    dx = (x - xf)[..., None]
    dy = (y - yf)[..., None]
    a = _fetch_rgba(tex, offset, width, height, xi, yi)
    b = _fetch_rgba(tex, offset, width, height, xi + 1, yi)
    c = _fetch_rgba(tex, offset, width, height, xi, yi + 1)
    d = _fetch_rgba(tex, offset, width, height, xi + 1, yi + 1)
    return ((1 - dx) * (1 - dy) * a + dx * (1 - dy) * b
            + (1 - dx) * dy * c + dx * dy * d)


def _eval_leaf(tex, ids, uv):
    """Evaluate the non-checker kinds for a batch of texture ids.  Returns
    RGBA before colorScale."""
    ids_c = torch.clamp(ids.to(torch.int64), 0,
                        tex["tex_info_i"].shape[0] - 1)
    info_i = tex["tex_info_i"][ids_c].to(torch.int64)
    info_f = tex["tex_info_f"][ids_c]
    kind = info_i[..., 0]
    img = _bilinear(tex, info_i[..., 1], torch.clamp(info_i[..., 2], min=1),
                    torch.clamp(info_i[..., 3], min=1), uv)
    solid = torch.cat([info_f[..., 5:8],
                       torch.ones_like(info_f[..., :1])], dim=-1)
    uvdbg = torch.stack([uv[..., 0], uv[..., 1],
                         torch.zeros_like(uv[..., 0]),
                         torch.ones_like(uv[..., 0])], dim=-1)
    out = torch.where((kind == KIND_SOLID)[..., None], solid,
                      torch.where((kind == KIND_UV)[..., None], uvdbg, img))
    return out, info_f[..., 0:3], info_i, info_f


def texture_eval_rgba(tex, ids, uv):
    """(rgb, alpha) of textures `ids` at `uv` for a lane batch; ids may be
    -1 (callers mask).  Handles one level of checker nesting."""
    rgba, cscale, info_i, info_f = _eval_leaf(tex, ids, uv)
    kind = info_i[..., 0]
    is_checker = kind == KIND_CHECKER
    inv = info_f[..., 3:5]
    cell = torch.floor(uv * inv).to(torch.int64)
    even = torch.remainder(cell[..., 0] + cell[..., 1], 2) == 0
    child = info_i[..., 5]
    child_id = torch.where(even, child & 0xFFFF, (child >> 16) & 0xFFFF)
    child_rgba, child_scale, _, _ = _eval_leaf(tex, child_id, uv)
    rgba = torch.where(is_checker[..., None],
                       child_rgba * torch.cat(
                           [child_scale,
                            torch.ones_like(child_scale[..., :1])], dim=-1),
                       rgba)
    rgb = rgba[..., :3] * cscale
    # alpha defaults to 1 for textures with fewer than 4 channels
    channels = info_i[..., 4]
    alpha = torch.where(channels == 4, rgba[..., 3], 1.0)
    return rgb, alpha


def texture_eval(tex, ids, uv):
    return texture_eval_rgba(tex, ids, uv)[0]


def texture_alpha(tex, ids, uv):
    return texture_eval_rgba(tex, ids, uv)[1]
