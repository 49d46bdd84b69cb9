"""Film: filter-weighted accumulation + image output (counterpart of
pathtracing_tpu/sensor/film.py).

The film is a dict of an [H*W,3] RGB sum and an [H*W] weight sum.  PNG and
JPG writing import Pillow lazily and are optional; PPM needs nothing.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.filters import FilterConfig, filter_weight, filter_integral


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
