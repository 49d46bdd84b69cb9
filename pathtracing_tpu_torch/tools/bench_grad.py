"""Frame-scale fwd+bwd: the gradient of the full-frame radiance sum with
respect to the material base colors (counterpart of bench.py's
bench_mesh_fwd_bwd_frame and bench_mesh_fwd_bwd_regen, the sources of its
fwd_bwd_samples_per_sec_* keys).

  fwd_bwd_frame   per-row-tile scan form (render_tile with
                  RenderConfig(differentiable=True, compact_after=compact)),
                  the tiles' gradients summed;
  fwd_bwd_regen   the recording wavefront (trace_regen_diff) over the queue
                  groups of render.regen_schedule, 65,536 lanes.

Each runs the frame once and returns camera samples per second with what
the run kept and launched (eager PyTorch compiles nothing, so a caller
only builds the kernels first, as any earlier call of them does):
peak device memory, the bytes the backward pass keeps per lane per bounce
(per iteration for the regen form), the traversal kernels' launches in the
forward and in the backward passes (K1 = accel/trace2.py, K2 =
accel/trace1.py), and whether every gradient is finite.  On the CPU the
device numbers (peak and held memory) are None.  chip_smoke.py's [grad]
phase runs them on the faithful frame.
"""
from __future__ import annotations

import time

import torch

from ..accel import trace1, trace2
from ..integrators.path import RenderConfig, _trace_regen
from ..integrators.regen_diff import _trace_regen_diff
from ..integrators.render import regen_schedule, render_tile
from ..sensor import film as filmmod

LANES = 1 << 16


def _launches():
    return {"trace2": trace2.tri_intersect2.launches,
            "trace1": trace1.tri_intersect1.launches}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _add(acc, d):
    for k, v in d.items():
        acc[k] = acc.get(k, 0) + v


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(dev):
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def _now(dev):
    """The host clock after the device has caught up."""
    _sync(dev)
    return time.perf_counter()


def _timed(run, dev):
    """(result of run(), its seconds, its peak device bytes)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = _now(dev)
    res = run()
    seconds = _now(dev) - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return res, seconds, peak


def fwd_bwd_frame(scene, cam, meta, depth=8, compact=3):
    """The scan form over row tiles of about LANES pixels, one sample
    each, the tile height a divisor of the frame height where one exists
    (bench.py's choice: every tile the same shape).  Each tile's loss is
    the sum of its own film (the rows splat into a film of the tile's
    height, as the reference's clamped row offset does)."""
    cfg = RenderConfig(spp=1, max_depth=depth, integrator="path",
                       differentiable=True, rays_per_batch=LANES,
                       compact_after=compact)
    w, h = cam["resolution"]
    dev = scene["mat_base"].device
    rows_max = max(1, LANES // w)
    rows = next((r for r in range(rows_max, 0, -1) if h % r == 0), rows_max)
    tiles = [(r0, min(rows, h - r0)) for r0 in range(0, h, rows)]

    def run():
        grad = torch.zeros_like(scene["mat_base"])
        fwd, bwd, held, split = {}, {}, [], {}
        for row0, n_rows in tiles:
            leaf = scene["mat_base"].detach().requires_grad_()
            film = filmmod.new_film((w, n_rows), device=dev)
            pix = row0 * w + torch.arange(n_rows * w, device=dev)
            a0, m0, t0 = _launches(), _allocated(dev), _now(dev)
            film = render_tile(dict(scene, mat_base=leaf), cam, meta, cfg,
                               film, pix, 1, 0, rows=n_rows, row0=0)
            loss = film["rgb"].sum()
            a1, t1 = _launches(), _now(dev)
            if m0 is not None:
                held.append((_allocated(dev) - m0, n_rows * w))
            loss.backward()
            _add(fwd, _delta(a1, a0))
            _add(bwd, _delta(_launches(), a1))
            _add(split, dict(fwd_s=t1 - t0, bwd_s=_now(dev) - t1))
            grad += leaf.grad
        return grad, fwd, bwd, held, split

    (grad, fwd, bwd, held, split), seconds, peak = _timed(run, dev)
    # what a tile's forward leaves for its backward, per camera lane per
    # bounce of the scan (the compacted tail's bounces counted as bounces)
    per = max(b / (n * depth) for b, n in held) if held else None
    return dict(samples_per_s=w * h / seconds, seconds=seconds,
                peak_bytes=peak, **split,
                bytes_per_lane_bounce=per, launches_fwd=fwd,
                launches_bwd=bwd, finite=bool(torch.isfinite(grad).all()),
                grad=grad, tiles=len(tiles), tile_rows=rows)


def regen_groups(cam):
    """The pixel groups (one queue each) and waves of a 1-spp regenerating
    render: render.regen_schedule over row tiles of LANES pixels."""
    w, h = cam["resolution"]
    rows_per = max(1, LANES // w)
    n_tiles = -(-h // rows_per)
    g_tiles, waves = regen_schedule(n_tiles, 1)
    rows_g = g_tiles * rows_per
    return [(r0 * w, min(r0 + rows_g, h) * w)
            for r0 in range(0, h, rows_g)], waves


def regen_forward(scene, cam, meta, depth, n_groups=None):
    """The plain regenerating forward (trace_regen, nothing recorded) over
    the frame's queue groups (the first n_groups of them), timed like the
    fwd+bwd runs: dict(seconds, outs (each group's radiance), launches
    (each group's K1 + K2 launches))."""
    cfg = RenderConfig(spp=1, max_depth=depth, integrator="path",
                       rays_per_batch=LANES)
    dev = scene["mat_base"].device
    groups, waves = regen_groups(cam)
    outs, launches = [], []
    t0 = _now(dev)
    for p0, p1 in groups[:n_groups]:
        a0 = _launches()
        outs.append(_trace_regen(scene, cam, meta, cfg,
                                 torch.arange(p0, p1, device=dev), waves, 0,
                                 lanes=LANES))
        launches.append(sum(_delta(_launches(), a0).values()))
    return dict(seconds=_now(dev) - t0, outs=outs, launches=launches)


def fwd_bwd_regen(scene, cam, meta, depth, sections=False):
    """trace_regen_diff over every queue group of the frame, LANES lanes,
    gradients summed.  bytes_per_lane_iter is what the recording keeps per
    lane per iteration (its residuals, measured from their tensors); outs
    holds each group's radiance, launches_fwd_by_group each group's
    forward K1 + K2 launches.  sections=True splits the backward passes
    into the shade replays and the torch.autograd.grad calls
    (backward_replay_s, backward_grad_s of bwd_s), with a device sync at
    each mark."""
    cfg = RenderConfig(spp=1, max_depth=depth, integrator="path",
                       rays_per_batch=LANES)
    w, h = cam["resolution"]
    dev = scene["mat_base"].device
    groups, waves = regen_groups(cam)

    def run():
        grad = torch.zeros_like(scene["mat_base"])
        fwd, bwd, stats, outs, by_group = {}, {}, {}, [], []
        for p0, p1 in groups:
            leaf = scene["mat_base"].detach().requires_grad_()
            pix = torch.arange(p0, p1, device=dev)
            st = dict(sections=sections)
            a0, t0 = _launches(), _now(dev)
            out = _trace_regen_diff(dict(scene, mat_base=leaf), cam, meta,
                                    cfg, pix, waves, 0, lanes=LANES, stats=st)
            loss = out.sum()
            a1, t1 = _launches(), _now(dev)
            loss.backward()
            _add(fwd, _delta(a1, a0))
            _add(bwd, _delta(_launches(), a1))
            by_group.append(sum(_delta(a1, a0).values()))
            _add(stats, dict(iterations=st["iterations"],
                             residual_bytes=st["residual_bytes"],
                             lane_iterations=st["iterations"] * st["lanes"],
                             n_rays=st["n_rays"], fwd_s=t1 - t0,
                             bwd_s=_now(dev) - t1))
            _add(stats, {k: st[k] for k in ("backward_replay_s",
                                            "backward_grad_s") if k in st})
            outs.append(out.detach())
            grad += leaf.grad
        return grad, fwd, bwd, stats, outs, by_group

    (grad, fwd, bwd, st, outs, by_group), seconds, peak = _timed(run, dev)
    return dict(samples_per_s=w * h * waves / seconds, seconds=seconds,
                peak_bytes=peak, fwd_s=st["fwd_s"],
                bwd_s=st["bwd_s"],
                backward_replay_s=st.get("backward_replay_s"),
                backward_grad_s=st.get("backward_grad_s"),
                bytes_per_lane_iter=st["residual_bytes"]
                / st["lane_iterations"], launches_fwd=fwd, launches_bwd=bwd,
                launches_fwd_by_group=by_group,
                finite=bool(torch.isfinite(grad).all()), grad=grad,
                outs=outs, iterations=st["iterations"],
                rays_per_sample=st["n_rays"] / (w * h * waves),
                groups=len(groups))
