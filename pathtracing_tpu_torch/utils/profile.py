"""Render timing and profiling (counterpart of
pathtracing_tpu/utils/profile.py).

  * `RenderTimer`: wall time of a render, synchronised with the device the
    result lies on, printed as one JSON metrics line with the derived
    camera-sample and ray rates;
  * `trace_to`: a torch.profiler trace around a block, written as a
    Chrome trace (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch


def _result_device(result):
    """The device of the first tensor in `result` (a tensor or a dict of
    them), or None."""
    if isinstance(result, torch.Tensor):
        return result.device
    if isinstance(result, dict):
        for v in result.values():
            if isinstance(v, torch.Tensor):
                return v.device
    return None


def _n_devices(device) -> int:
    """Ranks of the process group times the devices each rank sees."""
    ranks = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        ranks = torch.distributed.get_world_size()
    local = 1
    if device is not None and device.type == "cuda":
        local = torch.cuda.device_count()
    return ranks * local


class RenderTimer:
    """Usage:
        with RenderTimer(n_pixels, spp, max_depth) as t:
            film = render(...)
            t.result = film
    Prints a JSON metrics line on exit (to stderr unless `stream`) and
    keeps it as `t.metrics`."""

    def __init__(self, n_pixels: int, spp: int, max_depth: int,
                 label: str = "render", stream=None):
        self.n_pixels = n_pixels
        self.spp = spp
        self.max_depth = max_depth
        self.label = label
        self.result = None
        self.stream = stream or sys.stderr
        self.metrics = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        device = _result_device(self.result)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self.t0
        samples = self.n_pixels * self.spp
        self.metrics = dict(
            label=self.label, wall_s=round(dt, 4),
            camera_samples=samples,
            samples_per_s=round(samples / dt, 1),
            # an upper bound on traced rays (Russian roulette ends early)
            max_rays_per_s=round(samples * self.max_depth / dt, 1),
            n_devices=_n_devices(device),
        )
        print(json.dumps(self.metrics), file=self.stream)
        return False


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace of the block (CPU, and CUDA when present),
    written to `logdir`/trace.json as a Chrome trace.  Yields the
    profiler (its key_averages() give per-kernel totals)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
