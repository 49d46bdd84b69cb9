"""Adaptive sampling: Welford variance and the wave-loop stop rule
(counterpart of pathtracing_tpu/utils/adaptive.py).

Each wave renders base_spp samples of the pixels still above the
relative-variance target and updates their per-pixel (count, mean, m2);
a pixel stops once its 1.96-sigma relative error, summed over RGB, is at
most the target (after at least two waves) or after max_factor waves.
Each wave traces only the active pixels, gathered into a dense batch
padded to a power-of-two capacity (padding slots name pixel H*W, whose
splat the render drops).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device, to_device
from ..core.math import fsqrt


def welford_init(n, device=None):
    dev = resolve_device(device)
    return dict(count=torch.zeros((n,), dtype=torch.float32, device=dev),
                mean=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                m2=torch.zeros((n, 3), dtype=torch.float32, device=dev))


def welford_add(st, value, mask):
    """One Welford update of the lanes where `mask` is set."""
    m = mask.to(torch.float32)
    count = st["count"] + m
    safe = torch.clamp(count, min=1.0)
    delta = value - st["mean"]
    mean = st["mean"] + delta * (m / safe)[:, None]
    delta2 = value - mean
    m2 = st["m2"] + (delta * delta2) * m[:, None]
    return dict(count=count, mean=mean, m2=m2)


def relative_variance(st):
    """1.96 * stderr / mean, summed over RGB."""
    c = torch.clamp(st["count"], min=2.0)
    var = st["m2"] / (c - 1.0)[:, None]
    stderr = fsqrt(torch.clamp(var / c[:, None], min=0.0))
    amean = torch.abs(st["mean"])
    rel = torch.where(amean > 1e-8,
                      1.96 * stderr / torch.clamp(amean, min=1e-8), 0.0)
    return rel.sum(-1)


def _bucket(n: int, npix: int, floor: int) -> int:
    """Smallest capacity >= n stepping by powers of two from `floor`
    (capped at npix): few distinct batch shapes, under 2x padding."""
    c = min(floor, npix)
    while c < n:
        c = min(c * 2, npix)
    return c


def render_adaptive(scene, cam, meta, cfg, base_spp: int | None = None,
                    target: float = 1.5, max_factor: int = 128,
                    progress=None, bucket_floor: int = 4096, device=None):
    """Adaptive render: base_spp-sample waves over the active pixels until
    each meets the relative-variance target or max_factor waves.  With
    cfg.regenerate (and not cfg.differentiable) a wave drains its
    (pixel x base_spp) queue through render_tile_regen.  Runs on the GPU
    unless device="cpu".

    Returns (film, dict(spp_map [H*W] numpy, mean_spp, traced_samples))."""
    from ..integrators.render import render_tile, render_tile_regen
    from ..sensor.film import new_film

    dev = resolve_device(device)
    scene = to_device(scene, dev)
    cam = to_device(cam, dev)
    w, h = cam["resolution"]
    npix = w * h
    base_spp = base_spp or cfg.spp
    film = new_film(cam["resolution"], device=dev)
    est = welford_init(npix, device=dev)
    active = np.ones((npix,), bool)
    done_spp = np.zeros(npix, np.int32)
    traced = 0

    for wave in range(max_factor):
        idx_active = np.nonzero(active)[0]
        n_active = len(idx_active)
        if n_active == 0:
            break
        cap = _bucket(n_active, npix, bucket_floor)
        pixel_idx = np.full(cap, npix, np.int64)     # padding: off the image
        pixel_idx[:n_active] = idx_active
        pixel_idx = torch.from_numpy(pixel_idx).to(dev)
        traced += cap * base_spp
        scratch = new_film(cam["resolution"], device=dev)
        if cfg.regenerate and not cfg.differentiable:
            scratch = render_tile_regen(
                scene, cam, meta, cfg, scratch, pixel_idx, base_spp,
                wave * base_spp, lanes=min(cfg.rays_per_batch, cap))
        else:
            scratch = render_tile(scene, cam, meta, cfg, scratch, pixel_idx,
                                  base_spp, sample_offset=wave * base_spp)
        amask = torch.from_numpy(active).to(dev)
        val = scratch["rgb"] / torch.clamp(scratch["weight"],
                                           min=1e-12)[:, None]
        est = welford_add(est, val, amask)
        film = dict(
            rgb=film["rgb"] + torch.where(amask[:, None], scratch["rgb"],
                                          0.0),
            weight=film["weight"] + torch.where(amask, scratch["weight"],
                                                0.0))
        done_spp[active] += base_spp
        rel = relative_variance(est).cpu().numpy()
        # a pixel stops only with two or more waves observed (with one, m2
        # is 0 and every pixel would stop)
        can_stop = est["count"].cpu().numpy() >= 2
        active = active & ~((rel <= target) & can_stop)
        if progress:
            progress(wave + 1, int(active.sum()), npix)
    return film, dict(spp_map=done_spp, mean_spp=float(done_spp.mean()),
                      traced_samples=traced)
