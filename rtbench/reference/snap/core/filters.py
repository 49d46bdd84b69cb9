"""Reconstruction filters (counterpart of pathtracing_tpu/core/filters.py).

`filter_weight(cfg, p)` is a vectorized function of the sample offset
p=[...,2] used by the film splat; `filter_integral(cfg)` is the
normalisation, computed on the host as a Python float.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .math import fexp, fsin


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    kind: str = "mitchell"        # box | gaussian | mitchell | lanczos
    radius: tuple = (1.5, 1.5)
    sigma: float = 0.5            # gaussian
    b: float = 1.0 / 3.0          # mitchell
    c: float = 1.0 / 3.0
    tau: float = 3.0              # lanczos

    @property
    def pixel_radius(self) -> tuple:
        """ceil(radius - 0.5): whole pixels the splat reaches per side."""
        return (int(math.ceil(self.radius[0] - 0.5)),
                int(math.ceil(self.radius[1] - 0.5)))


def box(radius=(0.5, 0.5)):
    return FilterConfig(kind="box", radius=tuple(radius))


def gaussian(radius=(1.5, 1.5), sigma=0.5):
    return FilterConfig(kind="gaussian", radius=tuple(radius), sigma=sigma)


def mitchell(radius=(1.5, 1.5), b=1.0 / 3.0, c=1.0 / 3.0):
    return FilterConfig(kind="mitchell", radius=tuple(radius), b=b, c=c)


def lanczos(radius=(1.5, 1.5), tau=3.0):
    return FilterConfig(kind="lanczos", radius=tuple(radius), tau=tau)


def _gauss(x, sigma):
    if not isinstance(x, torch.Tensor):     # host constant, f32 like the lanes
        return float(_gauss(torch.tensor(x, dtype=torch.float32), sigma))
    return (1.0 / math.sqrt(math.pi) / (sigma * math.sqrt(2.0))
            * fexp(-(x * x) / (2.0 * sigma * sigma)))


def _gauss_integral(x0, x1, sigma) -> float:
    s = sigma * math.sqrt(2.0)
    return 0.5 * (math.erf(-x0 / s) - math.erf(-x1 / s))


def _mitchell_1d(x, b, c):
    ax = torch.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    inner = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2
             + (6 - 2 * b)) / 6.0
    outer = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
             + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0
    return torch.where(ax <= 1.0, inner, torch.where(ax <= 2.0, outer, 0.0))


def _sinc(x):
    px = math.pi * x
    small = 1.0 - x * x == 1.0
    return torch.where(small, 1.0,
                       fsin(px) / torch.where(small, 1.0, px))


def _windowed_sinc(x, radius, tau):
    return torch.where(torch.abs(x) > radius, 0.0,
                       _sinc(x) * _sinc(x / tau))


def filter_weight(cfg: FilterConfig, p):
    """Evaluate the 2D filter at offset p=[...,2]."""
    x, y = p[..., 0], p[..., 1]
    rx, ry = cfg.radius
    if cfg.kind == "box":
        return ((torch.abs(x) <= rx) & (torch.abs(y) <= ry)).to(torch.float32)
    if cfg.kind == "gaussian":
        ex = _gauss(rx, cfg.sigma)
        ey = _gauss(ry, cfg.sigma)
        return (torch.clamp(_gauss(x, cfg.sigma) - ex, min=0.0)
                * torch.clamp(_gauss(y, cfg.sigma) - ey, min=0.0))
    if cfg.kind == "mitchell":
        return (_mitchell_1d(2.0 * x / rx, cfg.b, cfg.c)
                * _mitchell_1d(2.0 * y / ry, cfg.b, cfg.c))
    if cfg.kind == "lanczos":
        return _windowed_sinc(x, rx, cfg.tau) * _windowed_sinc(y, ry, cfg.tau)
    raise ValueError(f"unknown filter kind {cfg.kind!r}")


def filter_integral(cfg: FilterConfig) -> float:
    """Analytic / quadrature filter integral."""
    rx, ry = cfg.radius
    if cfg.kind == "box":
        return 4.0 * rx * ry
    if cfg.kind == "gaussian":
        ex = _gauss(rx, cfg.sigma)
        ey = _gauss(ry, cfg.sigma)
        return ((_gauss_integral(-rx, rx, cfg.sigma) - 2 * rx * ex)
                * (_gauss_integral(-ry, ry, cfg.sigma) - 2 * ry * ey))
    if cfg.kind == "mitchell":
        return rx * ry / 4.0
    if cfg.kind == "lanczos":
        # deterministic midpoint quadrature
        n = 256
        xs = (np.arange(n) + 0.5) / n * 2 * rx - rx
        ys = (np.arange(n) + 0.5) / n * 2 * ry - ry
        gx, gy = np.meshgrid(xs, ys)
        p = torch.stack([torch.as_tensor(gx, dtype=torch.float32),
                         torch.as_tensor(gy, dtype=torch.float32)], dim=-1)
        w = filter_weight(cfg, p)
        return float(torch.mean(w)) * 4.0 * rx * ry
    raise ValueError(f"unknown filter kind {cfg.kind!r}")
