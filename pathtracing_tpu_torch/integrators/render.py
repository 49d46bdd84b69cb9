"""Render driver (counterpart of pathtracing_tpu/integrators/render.py).

The image is processed as row-aligned pixel batches x sample waves; each
batch's samples splat into the film through the dense row-tile path
(film.splat_rows) - no scatter.  With cfg.regenerate the batches of a few
row tiles form one persistent-wavefront queue (path.trace_regen; with
cfg.differentiable, regen_diff.trace_regen_diff).  The film's splats are
differentiable: gradients of a loss on the film reach the scene's
parameter arrays.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device, to_device
from ..sensor.camera import camera_lanes, film_position
from ..sensor import film as filmmod
from .path import RenderConfig, _trace, _trace_regen
from .regen_diff import _trace_regen_diff


def render_tile(scene, cam, meta, cfg: RenderConfig, film, pixel_idx,
                n_samples: int, sample_offset=0, rows: int | None = None,
                row0: int | None = None):
    """`n_samples` sample waves for one pixel batch.  When the batch covers
    whole image rows [row0, row0+rows) in row-major order the splat is the
    dense row-tile one, else a scatter with out-of-range pixels dropped.
    With cfg.differentiable each wave is the scan form of path.trace."""
    w, h = cam["resolution"]
    px = pixel_idx % w
    py = pixel_idx // w
    for s in range(n_samples):
        sample_idx = torch.full_like(pixel_idx, int(sample_offset) + s)
        origin, direction, time, p = camera_lanes(cam, cfg.sampler, px, py,
                                                  sample_idx)
        color = _trace(scene, meta, cfg, origin, direction, time, px, py,
                       sample_idx)
        color = torch.where(torch.isfinite(color), color, 0.0)   # NaN guard
        film = _splat(film, cfg, cam, pixel_idx, p, color, rows, row0)
    return film


def _splat(film, cfg, cam, pixel_idx, p, color, rows, row0):
    w, h = cam["resolution"]
    if rows is not None:
        return filmmod.splat_rows(film, cfg.filter, cam["resolution"], row0,
                                  rows, p, color)
    # out-of-range pixels (padding) splat off the image and are dropped
    p = torch.where((pixel_idx < w * h)[:, None], p, -1e6)
    return filmmod.splat(film, cfg.filter, cam["resolution"], p, color)


def render_tile_regen(scene, cam, meta, cfg: RenderConfig, film, pixel_idx,
                      waves: int, sample_offset, rows: int | None = None,
                      row0: int | None = None, lanes: int | None = None,
                      stats: dict | None = None):
    """Regenerative render of `waves` consecutive sample indices for one
    pixel batch (one trace_regen queue drain by `lanes` lanes; with
    cfg.differentiable, trace_regen_diff's recording drain), then one splat
    per wave — the film contract of render_tile.  `stats`, when given,
    accumulates "n_rays" (closest-hit + shadow rays traced),
    "occluded_calls" (shadow-predicate calls on a scene with alpha
    materials), "chain_restarts" (alpha restart-chain iterations),
    "iterations" (bounce iterations of the drain), "deep_bounces" (lane
    bounces at depth 20 or more: the drain's tail) and "deep_rehits" (those
    whose closest hit lies nearer than 1e-4); with cfg.differentiable,
    "n_rays", "iterations" and "residual_bytes" (trace_regen_diff)."""
    w, h = cam["resolution"]
    px = pixel_idx % w
    py = pixel_idx // w
    if cfg.differentiable:
        st = {}
        out = _trace_regen_diff(scene, cam, meta, cfg, pixel_idx, waves,
                                sample_offset, lanes=lanes, stats=st)
        st.pop("lanes", None)
    else:
        out, st = _trace_regen(scene, cam, meta, cfg, pixel_idx, waves,
                               sample_offset, lanes=lanes, with_stats=True)
    if stats is not None:
        for key, val in st.items():
            stats[key] = stats.get(key, 0) + int(val)
    k = pixel_idx.shape[0]
    for s_w in range(waves):
        sidx = torch.full_like(pixel_idx, int(sample_offset) + s_w)
        p = film_position(cfg.sampler, px, py, sidx)
        film = _splat(film, cfg, cam, pixel_idx, p,
                      out[s_w * k:(s_w + 1) * k], rows, row0)
    return film


REGEN_QUEUE_BATCHES = 4


def regen_schedule(n_tiles: int, spp: int, divisor: bool = False):
    """(g_tiles, waves_per_group) for a regenerative drain: a queue of about
    REGEN_QUEUE_BATCHES lane batches of samples per drain, so spp=1 renders
    regenerate across tiles.  divisor=True restricts g_tiles to divisors
    of n_tiles."""
    budget = REGEN_QUEUE_BATCHES
    g_tiles = min(n_tiles, max(1, budget // spp))
    if divisor:
        while n_tiles % g_tiles:
            g_tiles -= 1
    return g_tiles, max(1, budget // g_tiles)


def render(scene, cam, meta, cfg: RenderConfig, film=None, spp=None,
           sample_offset: int = 0, progress=None, device=None,
           stats: dict | None = None):
    """Full-frame render.  Returns the film dict (rgb + weight sums).
    Runs on the GPU unless device="cpu".  With cfg.regenerate, `stats`
    (a dict) accumulates "n_rays", the rays traced, the shadow predicate's
    "occluded_calls" and "chain_restarts", and the drain's "iterations",
    "deep_bounces" and "deep_rehits" (render_tile_regen).  With
    cfg.differentiable the film is differentiable in the scene's parameter
    arrays: regenerating renders of "path" / "simple" go through
    trace_regen_diff, volpath through the scan form (render_tile)."""
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    cam = to_device(cam, dev)
    w, h = cam["resolution"]
    npix = w * h
    spp = cfg.spp if spp is None else spp
    # row-aligned batches take the dense (scatter-free) film splat
    rows_per = max(1, min(cfg.rays_per_batch, npix) // w)
    batch = rows_per * w
    n_tiles = -(-h // rows_per)
    if film is None:
        film = filmmod.new_film(cam["resolution"], device=dev)
    else:
        film = to_device(film, dev)
    # the recording wavefront keeps no transmittance marches, so a
    # differentiable volpath render takes the scan form
    use_regen = cfg.regenerate and not (cfg.differentiable
                                        and cfg.integrator == "volpath")
    if use_regen:
        # queue groups of (consecutive row tiles) x (sample waves)
        g_tiles, wpg = regen_schedule(n_tiles, spp)
        t = 0
        while t < n_tiles:
            g = min(g_tiles, n_tiles - t)
            row0 = t * rows_per
            rows = min(g * rows_per, h - row0)
            pixel_idx = torch.arange(row0 * w, (row0 + rows) * w,
                                     dtype=torch.int64, device=dev)
            done = 0
            while done < spp:
                waves = min(wpg, spp - done)
                film = render_tile_regen(scene, cam, meta, cfg, film,
                                         pixel_idx, waves,
                                         sample_offset + done, rows, row0,
                                         lanes=batch, stats=stats)
                done += waves
            t += g
            if progress:
                progress(t, n_tiles)
        return film
    for t in range(n_tiles):
        row0 = t * rows_per
        rows = min(rows_per, h - row0)
        pixel_idx = torch.arange(row0 * w, (row0 + rows) * w,
                                 dtype=torch.int64, device=dev)
        film = render_tile(scene, cam, meta, cfg, film, pixel_idx, spp,
                           sample_offset, rows=rows, row0=row0)
        if progress:
            progress(t + 1, n_tiles)
    return film


def render_image(scene, cam, meta, cfg: RenderConfig,
                 tone_mapper="reinhard_jodie", device=None):
    """Render and return the [H,W,3] float image (weight-normalised,
    linear).  Runs on the GPU unless device="cpu"."""
    film = render(scene, cam, meta, cfg, device=device)
    w, h = cam["resolution"]
    return filmmod.finalize(film).reshape(h, w, 3)
