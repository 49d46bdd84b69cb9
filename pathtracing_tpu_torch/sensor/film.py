"""Film: filter-weighted accumulation + image output (counterpart of
pathtracing_tpu/sensor/film.py).

The film is a dict of an [H*W,3] RGB sum and an [H*W] weight sum.  PNG and
JPG writing import Pillow lazily and are optional; PPM needs nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.filters import FilterConfig, filter_weight, filter_integral
from ..core.tonemap import TONE_MAPPERS
from ..core.math import linear_to_srgb
from ..utils.profile import count


def new_film(resolution, device=None):
    """An empty film on `device` (None: the GPU, raising without one;
    "cpu" for the CPU)."""
    w, h = resolution
    device = resolve_device(device)
    return dict(rgb=torch.zeros((h * w, 3), dtype=torch.float32,
                                device=device),
                weight=torch.zeros((h * w,), dtype=torch.float32,
                                   device=device))


def splat(film, cfg: FilterConfig, resolution, p, color):
    """Accumulate `color` at continuous film positions p [N,2] over the
    (2r+1)^2 filter footprint.  Out-of-image taps go to a dump row that is
    dropped (a CUDA scatter faults on out-of-range indices)."""
    w, h = resolution
    rx, ry = cfg.pixel_radius
    inv_integral = 1.0 / filter_integral(cfg)
    pixel = torch.floor(p)
    frac = p - pixel
    pixel = pixel.to(torch.int64)

    idxs, vals = [], []
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            count("host_syncs")     # a copy to the device the host waits for
            offset = torch.tensor([dx, dy], dtype=torch.float32,
                                  device=p.device)
            fw = filter_weight(cfg, offset + 0.5 - frac) * inv_integral
            px = pixel[..., 0] + dx
            py = pixel[..., 1] + dy
            # bounds only: Mitchell/Lanczos negative lobes are kept
            inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            idxs.append(torch.where(inb, py * w + px, h * w))
            fw = torch.where(inb, fw, 0.0)
            vals.append(torch.cat([color * fw[..., None], fw[..., None]], -1))
    acc = torch.cat([film["rgb"], film["weight"][:, None]], -1)
    acc = torch.cat([acc, acc.new_zeros((1, 4))], 0)     # dump row h*w
    acc.index_add_(0, torch.cat(idxs), torch.cat(vals))
    acc = acc[:h * w]
    return dict(rgb=acc[:, :3], weight=acc[:, 3])


def splat_rows(film, cfg: FilterConfig, resolution, row0: int, rows: int, p,
               color):
    """Dense splat for a batch covering whole image rows [row0, row0+rows)
    in row-major order: every filter tap is a slice add into a padded row
    tile, merged into the film with one slice add (no scatter)."""
    w = p.shape[0] // rows
    h = film["rgb"].shape[0] // w
    rx, ry = cfg.pixel_radius
    inv_integral = 1.0 / filter_integral(cfg)
    frac = (p - torch.floor(p)).reshape(rows, w, 2)
    color = color.reshape(rows, w, 3)

    acc = torch.zeros((rows + 2 * ry, w + 2 * rx, 4), dtype=torch.float32,
                      device=p.device)
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            count("host_syncs")     # a copy to the device the host waits for
            offset = torch.tensor([dx, dy], dtype=torch.float32,
                                  device=p.device)
            fw = filter_weight(cfg, offset + 0.5 - frac) * inv_integral
            contrib = torch.cat([color * fw[..., None], fw[..., None]], -1)
            acc[dy + ry:dy + ry + rows, dx + rx:dx + rx + w] += contrib
    # crop x-padding (splats past the border are dropped); the y-extended
    # region merges into a y-padded image whose padding rows are cropped
    acc = acc[:, rx:rx + w, :]
    img = torch.cat([film["rgb"], film["weight"][:, None]],
                    -1).reshape(h, w, 4)
    img_pad = torch.nn.functional.pad(img, (0, 0, 0, 0, ry, ry))
    ext = rows + 2 * ry
    img_pad[row0:row0 + ext] += acc
    img = img_pad[ry:ry + h]
    return dict(rgb=img[..., :3].reshape(h * w, 3),
                weight=img[..., 3].reshape(h * w))


def finalize(film):
    """RGB / weight."""
    return film["rgb"] / torch.clamp(film["weight"], min=1e-12)[..., None]


def to_uint8(film, resolution, tone_mapper="reinhard_jodie"):
    """Tone map + linear->sRGB + vertical flip.  Returns an [H,W,3] uint8
    numpy array with row 0 at the top."""
    w, h = resolution
    color = finalize(film).reshape(h, w, 3)
    color = TONE_MAPPERS[tone_mapper](color)
    srgb = linear_to_srgb(color)
    img = torch.clamp(srgb * 255.999, 0.0, 255.0).to(torch.uint8)
    return np.ascontiguousarray(img.cpu().numpy()[::-1])


def write_png(film, resolution, path, tone_mapper="reinhard_jodie"):
    from PIL import Image
    Image.fromarray(to_uint8(film, resolution, tone_mapper)).save(str(path))


def write_jpg(film, resolution, path, quality=90,
              tone_mapper="reinhard_jodie"):
    from PIL import Image
    Image.fromarray(to_uint8(film, resolution, tone_mapper)).save(
        str(path), quality=quality)


def write_ppm(film, resolution, path, tone_mapper="reinhard_jodie"):
    img = to_uint8(film, resolution, tone_mapper)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
