"""Render timing, profiling and the program's own tracing (counterpart of
pathtracing_tpu/utils/profile.py, plus the spans and counters).

  * `RenderTimer`: wall time of a render, synchronised with the device the
    result lies on, printed as one JSON metrics line with the derived
    camera-sample and ray rates;
  * `trace_to`: a torch.profiler trace around a block, written as a
    Chrome trace (chrome://tracing, Perfetto), the program's spans in it;
  * `span(name)`: what the host is doing, at the program's layer
    boundaries (the bounce loop, the dispatch, the kernel launches, the
    shading, the shadow predicate, the backward pass, the scene build).
    Spans record only while a torch.profiler session runs in the process
    or inside `recording()`; otherwise `span` tests one flag and returns a
    shared no-op context (no allocation, no clock read).  A span never
    synchronises the device.  Each record is (name, parent index, item id,
    thread id, start_ns, end_ns) on `time.time_ns()`'s clock, the Unix-epoch
    clock torch.profiler stamps its events with, so `charge_idle` can
    charge each idle instant of the device to the innermost span open then
    (`idle_share`: the share charged to some spans);
  * `count(name, n)`: always-on host counters ("host_syncs": the places
    the render path makes the host wait for the device, blocking reads of
    device values and copies of host data to the device; "build.*_s": the
    seconds of the last scene build's stages; "kernels.<name>_s": a CUDA
    kernel library's build and load; "rng.launches": launches of the
    sampler kernel, core/rng.py; "sort_key.launches": launches of the
    dispatch sort key's kernel, scene/intersect.py), read by `counters()`.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.autograd.profiler as _tap

# spans kept at most; the ones past it are counted in `dropped()`
MAX_SPANS = 1 << 20
_spans: list = []       # [name, parent, item, tid, start_ns, end_ns]
_lock = threading.Lock()
_local = threading.local()      # each thread's stack of open span indices
_forced = 0             # depth of open recording() blocks
_item = 0               # the id of the last work item opened
_dropped = 0
_counters: dict = {}
_OFF = contextlib.nullcontext()


def is_recording() -> bool:
    """True inside `recording()` or while torch.profiler records."""
    return bool(_forced or _tap._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record spans in the block, with or without a profiler session."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class _Span:
    __slots__ = ("rec", "new_item")

    def __init__(self, name, new_item):
        self.rec = [name, -1, 0, threading.get_native_id(), 0, 0]
        self.new_item = new_item

    def __enter__(self):
        global _item, _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        with _lock:
            if self.new_item:
                _item += 1
            rec[1] = stack[-1] if stack else -1
            rec[2] = _item
            if len(_spans) < MAX_SPANS:
                stack.append(len(_spans))
                _spans.append(rec)
            else:
                # children hang from the nearest span that was kept
                _dropped += 1
                stack.append(rec[1])
                self.rec = None
        if self.rec is not None:
            rec[4] = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[5] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str, new_item: bool = False):
    """A context manager around a layer's work on the host.  new_item=True
    (the root span of a work item) takes a new item id, which every span
    opened until the next one carries."""
    if _forced or _tap._is_profiler_enabled:
        return _Span(name, new_item)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs in span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _forced or _tap._is_profiler_enabled:
                with _Span(name, False):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def spans(since: int = 0) -> list:
    """The finished spans recorded from index `since` (a `span_mark()`) on,
    as (name, parent, item id, thread id, start_ns, end_ns) tuples in the
    order they opened; parent is the parent's position in this list, -1
    for a root or a parent left out."""
    with _lock:
        recs = _spans[since:]
    pos, out = {}, []
    for i, r in enumerate(recs):
        if r[5]:
            pos[since + i] = len(out)
            out.append((r[0], pos.get(r[1], -1), *r[2:]))
    return out


def span_mark() -> int:
    """The index the next recorded span gets (for spans(since=))."""
    return len(_spans)


def dropped() -> int:
    """Spans not kept because the buffer held MAX_SPANS."""
    return _dropped


def count(name: str, n=1):
    """Add n to the host counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def host_any(x) -> bool:
    """bool(x.any()) on the host: a blocking read of a device value,
    counted in "host_syncs"."""
    _counters["host_syncs"] = _counters.get("host_syncs", 0) + 1
    return bool(x.any().item())


def set_count(name: str, value):
    """Set the host counter `name` (the seconds of the last build)."""
    _counters[name] = value


def counters() -> dict:
    """A snapshot of the host counters."""
    return dict(_counters)


def self_seconds(recs) -> dict:
    """{span name: seconds} over `spans()` records: each span's duration
    less its children's (a layer's self time), summed by name."""
    own = [(r[5] - r[4]) / 1e9 for r in recs]
    cover = [0.0] * len(recs)
    for r, d in zip(recs, own):
        if r[1] >= 0:
            cover[r[1]] += d
    out = {}
    for r, d, c in zip(recs, own, cover):
        out[r[0]] = out.get(r[0], 0.0) + d - c
    return out


def charge_idle(dev_us, recs, lo=None, hi=None, issued=None):
    """Charge the device's idle time to the program's spans.

    dev_us: the device operations' (start, end) intervals in us on the
    profiler's clock (a [N, 2] array); recs: `spans()` records (ns, the same
    clock).  Between lo and hi (default: the first operation's start and
    the last one's end) the time no operation covers is idle; each idle
    instant is charged to the innermost span open at that instant on any
    thread (the open span that started last), or to none when no span is
    open.  issued: each operation's issue time in us on the host's clock
    (`issue_times`), or None.  With it each gap is moved to end when the
    host issued the operation that ends it: over a trace of seconds the
    device's timestamps drift by milliseconds against the host's, the issue
    records do not, and a device left idle starts an operation as soon as
    it is issued.  Returns (idle us in all, [idle us charged to each
    record]); the idle charged to no span is the first less the sum of the
    second."""
    dev = np.asarray(dev_us, np.float64).reshape(-1, 2)
    charged = [0.0] * len(recs)
    if not len(dev):
        return 0.0, charged
    order = np.argsort(dev[:, 0], kind="stable")
    dev = dev[order]
    lo = float(dev[0, 0]) if lo is None else float(lo)
    hi = float(dev[:, 1].max()) if hi is None else float(hi)
    # the gaps: from the running end of the operations so far to the next
    # start, then to hi
    run_end = np.maximum.accumulate(dev[:, 1])
    gs = np.maximum(np.concatenate([[lo], run_end]), lo)
    ge = np.minimum(np.concatenate([dev[:, 0], [hi]]), hi)
    if issued is not None:
        shift = np.asarray(issued, np.float64)[order] - dev[:, 0]
        shift = np.concatenate([shift, shift[-1:]])
        keep = ge > gs
        gs, ge = gs[keep] + shift[keep], ge[keep] + shift[keep]
        # on the host's clock two gaps may touch: the later one yields
        by_end = np.argsort(ge, kind="stable")
        gs, ge = gs[by_end], ge[by_end]
        gs = np.maximum(gs, np.concatenate([[-np.inf], ge[:-1]]))
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    if not len(gs):
        return 0.0, charged
    cum = np.concatenate([[0.0], np.cumsum(ge - gs)])

    def idle_to(t):
        """Idle us before t, for each t."""
        t = np.asarray(t, np.float64)
        j = np.searchsorted(gs, t, side="right") - 1
        jj = np.clip(j, 0, None)
        part = np.clip(t - gs[jj], 0.0, ge[jj] - gs[jj])
        return np.where(j >= 0, cum[jj] + part, 0.0)

    # sweep the span boundaries: between two of them the innermost open
    # span is fixed
    ev = []
    for k, r in enumerate(recs):
        s, e = r[4] / 1e3, r[5] / 1e3
        if e > s:
            ev.append((s, 1, k))
            ev.append((e, 0, k))
    ev.sort()
    at = idle_to([t for t, _, _ in ev])
    open_ = {}          # span index -> its start
    for i, (t, opening, k) in enumerate(ev):
        if opening:
            open_[k] = t
        else:
            del open_[k]
        if i + 1 < len(ev) and open_:
            inner = max(open_, key=lambda j: (open_[j], j))
            charged[inner] += float(at[i + 1] - at[i])
    return float(cum[-1]), charged


# the CUDA runtime calls that put work on a stream, by the kind of device
# operation each makes: copies, sets, kernels
_ISSUERS = (("Memcpy", ("cudaMemcpy",)), ("Memset", ("cudaMemset",)),
            ("", ("cudaLaunchKernel", "cuLaunchKernel")))


def _kind(name, issuer):
    for k, (dev_prefix, host_prefixes) in enumerate(_ISSUERS):
        if name.startswith(host_prefixes if issuer else dev_prefix):
            return k
    return None


def issue_times(dev_names, dev_us, host_names, host_us):
    """Each device operation's issue time in us on the host's clock: the
    start of the CUDA runtime call that enqueued it (torch.profiler's
    records of the runtime API), matched in order within each kind
    (copies, sets, kernels), since one stream runs its work in the order
    it was issued.  An array like dev_us[:, 0], or None when the counts
    of a kind differ (work on a second stream, records lost)."""
    dev_us = np.asarray(dev_us, np.float64).reshape(-1, 2)
    host_us = np.asarray(host_us, np.float64).reshape(-1, 2)
    out = np.full(len(dev_us), np.nan)
    for k in range(len(_ISSUERS)):
        ops = [i for i, n in enumerate(dev_names) if _kind(n, False) == k]
        calls = [i for i, n in enumerate(host_names) if _kind(n, True) == k]
        if len(ops) != len(calls):
            return None
        ops.sort(key=lambda i: dev_us[i, 0])
        calls.sort(key=lambda i: host_us[i, 0])
        out[ops] = host_us[calls, 0]
    return out


def idle_share(dev_names, dev_us, host_names, host_us, recs, names,
               subtree=False):
    """The share (%) of a device trace's idle time (`charge_idle`, the gaps
    placed by `issue_times` where the trace's runtime records match its
    operations, by the device's clock otherwise) charged to the spans
    named in `names`, and with subtree=True to every span under one of
    them.  None when no such span was recorded or the device never
    idled."""
    picked = []
    for r in recs:
        picked.append(r[0] in names
                      or (subtree and r[1] >= 0 and picked[r[1]]))
    if not any(picked) or not len(dev_us):
        return None
    issued = issue_times(dev_names, dev_us, host_names, host_us)
    total, charged = charge_idle(dev_us, recs, issued=issued)
    if not total:
        return None
    return 100.0 * sum(c for p, c in zip(picked, charged) if p) / total


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
    written to `logdir`/trace.json as a Chrome trace with the program's
    spans of the block in it, on the thread that ran each (category
    "program"; args: the item id and the parent's position).  Yields the
    profiler (its key_averages() give per-kernel totals)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    mark = span_mark()
    with profile(activities=acts) as prof:
        yield prof
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    _insert_spans(path, spans(mark))


def _insert_spans(path: Path, recs):
    """Put `spans()` records into a Chrome trace written by torch.profiler:
    "X" events at the head of its traceEvents list, on the trace's own time
    base, by one copy of the file (a frame's trace runs to gigabytes and is
    never parsed)."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    m = re.search(rb'"traceEvents"\s*:\s*\[', head)
    if m is None:
        raise ValueError(f"{path}: no traceEvents list in its first MiB")
    # the events are in us after the trace's time base
    b = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base = int(b.group(1)) if b else 0
    more = not head[m.end():].lstrip().startswith(b"]")
    pid = os.getpid()
    tmp = path.with_name(path.name + ".part")
    with open(path, "rb") as src, open(tmp, "wb") as dst:
        dst.write(src.read(m.end()))
        for i, (name, parent, item, tid, t0, t1) in enumerate(recs):
            ev = dict(ph="X", cat="program", name=name, pid=pid, tid=tid,
                      ts=(t0 - base) / 1e3, dur=(t1 - t0) / 1e3,
                      args=dict(item=item, parent=parent))
            sep = b",\n" if i + 1 < len(recs) or more else b"\n"
            dst.write(json.dumps(ev).encode() + sep)
        shutil.copyfileobj(src, dst, 1 << 24)
    os.replace(tmp, path)
