"""Device time from a torch.profiler trace.

`DeviceTrace` records one stretch of work under torch.profiler (device
activity) and reads from it: every device operation's interval
(kernels, copies and sets, those launched through ctypes included: CUPTI
sees every launch of the process), their union (the device's busy
seconds), the device time by operation name, and the gaps in which the
device ran nothing, each labelled by the innermost CUDA runtime call
(launch, synchronise, copy) that spans it.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start, end):
    """The (start, end) stretches of [start, end] that no interval
    covers."""
    out = []
    cur = start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def _events(prof):
    """(device events, host events) as (names, [N, 2] start / end in us)
    arrays.  Numpy arrays and a list of names: the hundreds of thousands of
    events of a frame must not stay behind as Python objects the cyclic
    garbage collector walks (it slowed the next item by half)."""
    dev_n, dev_t, host_n, host_t = [], [], [], []
    kr = getattr(prof.profiler, "kineto_results", None)
    cuda = torch.autograd.DeviceType.CUDA
    if kr is not None:
        for e in kr.events():
            s = e.start_ns() / 1e3
            if e.device_type() == cuda:
                dev_n.append(e.name())
                dev_t.append((s, s + e.duration_ns() / 1e3))
            else:
                host_n.append(e.name())
                host_t.append((s, s + e.duration_ns() / 1e3))
    else:
        for e in prof.events():
            (dev_n if e.device_type == cuda else host_n).append(e.name)
            (dev_t if e.device_type == cuda else host_t).append(
                (e.time_range.start, e.time_range.end))
    return (dev_n, np.asarray(dev_t, np.float64).reshape(-1, 2),
            host_n, np.asarray(host_t, np.float64).reshape(-1, 2))


# host records of the profiler's own work: a gap under one of these is the
# profiler's, not the program's
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


class DeviceTrace:
    def __init__(self):
        self.dev_names, self.dev = [], np.zeros((0, 2))
        self.host_names, self.host = [], np.zeros((0, 2))
        self.window_s = 0.0

    def run(self, fn):
        """fn() under the profiler; the window is from the profiler's start
        to the device's end of fn's work."""
        from torch.profiler import profile, ProfilerActivity
        torch.cuda.synchronize()
        # device activity only: the host-side op profiler slows this
        # host-bound loop by half again; CUPTI's runtime-API records
        # (launches, syncs, copies) label the gaps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self.dev_names, self.dev, self.host_names, self.host = _events(prof)
        del prof
        gc.collect()
        return out

    def busy_s(self) -> float:
        return union_seconds(map(tuple, self.dev)) / 1e6

    def by_name(self):
        """{operation name: device seconds}."""
        out = {}
        for name, (s, e) in zip(self.dev_names, self.dev):
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def seconds_matching(self, *parts) -> float | None:
        """Device seconds of the operations whose name holds one of
        `parts`; None when none ran."""
        hits = [e - s for name, (s, e) in zip(self.dev_names, self.dev)
                if any(p in name for p in parts)]
        return sum(hits) / 1e6 if hits else None

    def idle_gaps(self, top=10):
        """The longest idle stretches between the first and the last device
        operation, each labelled by the innermost host record spanning its
        middle ("host" where none does), the profiler's own left out:
        [[label, seconds], ...]."""
        if not len(self.dev):
            return []
        lo, hi = float(self.dev[:, 0].min()), float(self.dev[:, 1].max())
        out = []
        hs, he = self.host[:, 0], self.host[:, 1]
        for s, e in sorted(gaps(map(tuple, self.dev), lo, hi),
                           key=lambda g: g[0] - g[1]):
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (mid <= he))[0]
            label = "host"
            if len(cover):
                label = self.host_names[int(cover[np.argmin(
                    (he - hs)[cover])])]
            if label in PROFILER_OWN:
                continue
            out.append([label, (e - s) / 1e6])
            if len(out) == top:
                break
        return out

    def top_ops(self, top=10, width=160):
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return [[name[:width], sec] for name, sec in ops]
