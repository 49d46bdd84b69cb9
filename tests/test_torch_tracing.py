"""The port's own tracing (pathtracing_tpu_torch/utils/profile.py): spans
at the bounce loop's layer boundaries, recorded only while a profiler
session runs or inside recording(); the "host_syncs" counter of blocking
reads of device values; the idle-charging arithmetic; the build's stage
counters."""
import contextlib
import time

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.core.rng import SamplerConfig
from pathtracing_tpu_torch.integrators.path import RenderConfig
from pathtracing_tpu_torch.integrators.render import render_tile_regen
from pathtracing_tpu_torch.scenes import sanmiguel_analog, cornell_box
from pathtracing_tpu_torch.sensor.film import new_film
from pathtracing_tpu_torch.utils import profile

RES = (48, 32)


def _alpha_scene():
    """A small San-Miguel-class scene on the traversal tables, with alpha
    foliage in its own tables: the shadow predicate runs its restart
    chain."""
    return sanmiguel_analog(resolution=RES, n_tris=6000, foliage=12,
                            device="cpu")


@pytest.fixture(scope="module")
def alpha_scene():
    return _alpha_scene()


def _drain(scene, cam, meta, stats=None, depth=8):
    cfg = RenderConfig(spp=1, max_depth=depth, integrator="path",
                       sampler=SamplerConfig(x_samples=1, y_samples=1,
                                             seed=3),
                       regenerate=True)
    w, h = cam["resolution"]
    return render_tile_regen(scene, cam, meta, cfg,
                             new_film(cam["resolution"], device="cpu"),
                             torch.arange(w * h), 1, 0, lanes=2048,
                             stats=stats)


def test_torch_spans_off_record_nothing(monkeypatch):
    """With recording off a render records no span and makes no span
    object: span() hands back one shared no-op context."""
    assert not profile.is_recording()
    assert profile.span("a") is profile.span("b")

    def refuse(*a, **k):
        raise AssertionError("a span was made with recording off")
    monkeypatch.setattr(profile, "_Span", refuse)
    scene, cam, meta = cornell_box(resolution=(8, 8), device="cpu")
    mark = profile.span_mark()
    st = {}
    _drain(scene, cam, meta, st, depth=4)
    assert profile.span_mark() == mark
    assert "deep_bounces" not in st and st["iterations"] > 0


def _ancestors(recs, k):
    out = []
    while recs[k][1] >= 0:
        k = recs[k][1]
        out.append(recs[k][0])
    return out


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_torch_spans_nest_at_the_layer_boundaries(alpha_scene, how):
    """Under recording() and under torch.profiler the drain records
    wavefront.item > wavefront.iteration > {intersect.dispatch, shading.*,
    intersect.shadow}, each child inside its parent on the parent's
    thread, every span of the drain with the item's id; the film is the
    unrecorded one."""
    scene, cam, meta = alpha_scene
    plain = _drain(scene, cam, meta)
    mark = profile.span_mark()
    if how == "recording":
        ctx = profile.recording()
    else:
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    with ctx:
        film = _drain(scene, cam, meta)
    assert not profile.is_recording()
    assert torch.equal(film["rgb"], plain["rgb"])
    recs = profile.spans(mark)
    names = {r[0] for r in recs}
    assert {"wavefront.item", "wavefront.iteration", "film.splat",
            "intersect.dispatch", "intersect.sort_key", "intersect.shadow",
            "intersect.shadow_restart", "shading.interaction",
            "shading.material", "shading.bsdf",
            "shading.lights"} <= names
    assert recs[0][0] == "wavefront.item" and recs[0][1] == -1
    assert sum(r[0] == "wavefront.item" for r in recs) == 1
    assert {r[2] for r in recs} == {recs[0][2]}
    for k, r in enumerate(recs):
        assert r[4] <= r[5]
        if r[1] >= 0:
            p = recs[r[1]]
            assert p[3] == r[3] and p[4] <= r[4] and r[5] <= p[5]
        else:
            assert r[0] == "wavefront.item"
        up = _ancestors(recs, k)
        if r[0] == "wavefront.iteration":
            assert up == ["wavefront.item"]
        if r[0].startswith(("shading.", "intersect.")):
            assert "wavefront.iteration" in up
        if r[0] == "intersect.shadow":
            assert up[0] == "shading.lights"
        if r[0] == "intersect.shadow_restart":
            assert up[0] == "intersect.shadow"
    it = sum(r[0] == "wavefront.iteration" for r in recs)
    assert it == sum(r[0] == "intersect.shadow" for r in recs)


def test_torch_spans_record_into_a_capped_buffer(monkeypatch):
    """Past MAX_SPANS a span is dropped and counted; its children hang from
    the nearest span kept."""
    mark, dropped = profile.span_mark(), profile.dropped()
    monkeypatch.setattr(profile, "MAX_SPANS", mark + 2)
    with profile.recording():
        with profile.span("a", new_item=True):
            with profile.span("b"):
                with profile.span("c"):
                    with profile.span("d"):
                        pass
    recs = profile.spans(mark)
    assert [(r[0], r[1]) for r in recs] == [("a", -1), ("b", 0)]
    assert profile.dropped() == dropped + 2
    assert recs[0][2] == recs[1][2] > 0


class _Reads:
    """Counts the blocking reads of tensor values made from Python and the
    copies of host data to a device."""

    def __init__(self, monkeypatch):
        self.n = 0
        T = torch.Tensor
        for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "__index__", "nonzero", "cpu", "numpy"):
            monkeypatch.setattr(T, name, self._counted(getattr(T, name)))
        monkeypatch.setattr(torch, "nonzero", self._counted(torch.nonzero))
        # host data copied to a tensor's device: the host waits for it on a
        # card
        monkeypatch.setattr(T, "new_tensor", self._counted(T.new_tensor))
        for name in ("tensor", "as_tensor"):
            monkeypatch.setattr(torch, name, self._to_device(
                getattr(torch, name)))
        get = T.__getitem__

        def getitem(x, idx):
            keys = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(k, torch.Tensor) and k.dtype == torch.bool
                   for k in keys):
                self.n += 1
            return get(x, idx)
        monkeypatch.setattr(T, "__getitem__", getitem)

    def _to_device(self, fn):
        def call(data, *a, **k):
            if k.get("device") is not None \
                    and not isinstance(data, torch.Tensor):
                self.n += 1
            return fn(data, *a, **k)
        return call

    def _counted(self, fn):
        def call(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return call


def test_torch_host_syncs_count_every_blocking_read(alpha_scene,
                                                     monkeypatch):
    """stats["host_syncs"] of a drain with the alpha restart chain equals
    the blocking reads of tensor values the drain makes (item, tolist,
    bool, int, float, nonzero, a boolean-mask index) and its copies of host
    data to a tensor's device (new_tensor, tensor or as_tensor with a
    device), with and without spans recording."""
    scene, cam, meta = alpha_scene
    for rec in (False, True):
        st = {}
        with monkeypatch.context() as mp:
            reads = _Reads(mp)
            with profile.recording() if rec else contextlib.nullcontext():
                _drain(scene, cam, meta, st)
        assert st["chain_restarts"] > 0 and st["occluded_calls"] > 0
        assert st["host_syncs"] == reads.n > st["iterations"]
        assert ("deep_bounces" in st) == rec


def test_torch_span_lines_up_with_the_profilers_clock():
    """A span and a record_function over the same block start and end
    within 1 ms of each other on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    mark = profile.span_mark()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        with profile.span("probe"), \
                torch.profiler.record_function("probe_rf"):
            x = torch.randn(256, 256)
            for _ in range(20):
                x = torch.tanh(x @ x)
            time.sleep(0.01)
    (rec,) = [r for r in profile.spans(mark) if r[0] == "probe"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe_rf"]
    assert len(ev) == 1
    s, e = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert abs(s - rec[4]) < 1e6 and abs(e - rec[5]) < 1e6
    assert rec[5] - rec[4] >= 1e7


def test_torch_charge_idle_arithmetic():
    """Idle time between the first and the last device operation goes to
    the innermost span open at each instant on any thread, none where no
    span is open; self time is a span less its children."""
    # device busy [0, 3], [5, 6], [9, 10], [14, 15] (us): idle (3, 5),
    # (6, 9), (10, 14) = 9 us
    dev = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (9.0, 10.0),
           (14.0, 15.0)]
    us = 1000
    recs = [("a", -1, 1, 7, 0 * us, 10 * us),    # thread 7
            ("b", 0, 1, 7, 4 * us, 8 * us),      # inside a
            ("c", -1, 1, 8, 7 * us, 7.5 * us),   # thread 8, opens in b
            ("d", -1, 2, 7, 12 * us, 13 * us)]   # a gap partly under none
    total, charged = profile.charge_idle(np.asarray(dev), recs)
    assert total == pytest.approx(9.0)
    # a: 3-4, 8-9; b: 4-5, 6-7, 7.5-8; c: 7-7.5; d: 12-13; none: 10-12,
    # 13-14
    assert charged == pytest.approx([2.0, 2.5, 0.5, 1.0])
    assert total - sum(charged) == pytest.approx(3.0)
    # a stretch given explicitly: only (6, 9) and (10, 12) are in [6, 12]
    total, charged = profile.charge_idle(np.asarray(dev), recs, lo=6.0,
                                         hi=12.0)
    assert total == pytest.approx(5.0)
    assert charged == pytest.approx([1.0, 1.5, 0.5, 0.0])
    assert profile.charge_idle(np.zeros((0, 2)), recs) == (0.0, [0.0] * 4)
    own = profile.self_seconds(recs)
    assert own == pytest.approx(dict(a=6e-6, b=4e-6, c=0.5e-6, d=1e-6))


def test_torch_idle_share_places_gaps_at_issue_time():
    """With the runtime's issue records each idle gap is moved onto the
    host's clock, to end when the host issued the operation that ends it
    (the device's clock here runs 100 us ahead), and idle_share sums the
    charge of the named spans (subtree: and of their children); with the
    records unmatched the gaps stay on the device's clock."""
    dev_names = ["kern_a", "Memcpy HtoD (Pageable -> Device)", "kern_b",
                 "kern_c"]
    dev = np.asarray([(100.0, 101.0), (105.0, 106.0), (110.0, 111.0),
                      (120.0, 121.0)])
    host_names = ["cudaLaunchKernel", "cudaStreamSynchronize",
                  "cudaMemcpyAsync", "cudaLaunchKernel", "cudaLaunchKernel"]
    host = np.asarray([(0.0, 0.1), (1.0, 4.9), (5.0, 5.1), (10.0, 10.1),
                       (20.0, 20.1)])
    issued = profile.issue_times(dev_names, dev, host_names, host)
    assert issued.tolist() == [0.0, 5.0, 10.0, 20.0]
    assert profile.issue_times(dev_names, dev, host_names[:2],
                               host[:2]) is None
    us = 1000
    recs = [("a", -1, 1, 7, 0.5 * us, 5.5 * us),
            ("b", -1, 1, 7, 7 * us, 25 * us),
            ("c", 1, 1, 9, 12 * us, 15 * us)]      # under b, another thread
    # gaps on the host's clock: (1, 5) under a; (6, 10): none to 7, then b;
    # (11, 20): b, c over 12-15, b
    total, charged = profile.charge_idle(dev, recs, issued=issued)
    assert total == pytest.approx(17.0)
    assert charged == pytest.approx([4.0, 9.0, 3.0])
    # an issue time that pulls a gap onto the one before: the later gap
    # yields, (6, 15) becomes (10, 15)
    early = issued.copy()
    early[3] = 15.0
    total, charged = profile.charge_idle(dev, recs, issued=early)
    assert total == pytest.approx(13.0)
    assert charged == pytest.approx([4.0, 5.0, 3.0])
    share = profile.idle_share(dev_names, dev, host_names, host, recs, ("b",))
    assert share == pytest.approx(100.0 * 9 / 17)
    assert profile.idle_share(dev_names, dev, host_names, host, recs, ("b",),
                              subtree=True) == pytest.approx(100.0 * 12 / 17)
    assert profile.idle_share(dev_names, dev, host_names, host, recs,
                              ("z",)) is None
    # unmatched records: the device's clock, where no span is open
    assert profile.idle_share(dev_names, dev, host_names[:2], host[:2], recs,
                              ("a",)) == 0.0
    assert profile.idle_share([], np.zeros((0, 2)), [], np.zeros((0, 2)),
                              recs, ("a",)) is None


def test_torch_build_counts_its_stages():
    """A build sets the seconds of its traversal tables (mask build
    included) and of its upload in the host counters."""
    profile.set_count("build.tables_s", -1.0)
    _alpha_scene()
    c = profile.counters()
    assert c["build.tables_s"] >= c["build.masks_s"] > 0
    assert c["build.upload_s"] > 0
    cornell_box(resolution=(8, 8), device="cpu")     # no traversal tables
    c = profile.counters()
    assert c["build.tables_s"] == 0 and c["build.masks_s"] == 0
