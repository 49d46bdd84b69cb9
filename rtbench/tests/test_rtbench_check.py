"""CPU tests of the frozen scene, the reference and the check.

A tiny scene of the same generator runs through the whole of a cell's
run (set-up, window, capture, check) on the CPU with the port's plain
traversal; the check passes, and fails when the timed path is broken
underneath or the lower-precision control stands in its place.
"""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

from rtbench.scenedesc import load_generator, replay
from rtbench.run import run_cell
from rtbench.reference.snap.scene.builder import SceneBuilder as RefBuilder

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(resolution=(64, 36), n_tris=20000, foliage=40)
MIX = dict(lanes=1024, rows_per_tile=1, tiles_per_item=16, check_lanes=48,
           max_depth=6)


@pytest.mark.parametrize("faithful", [True, False])
def test_frozen_generator_matches_the_port(faithful):
    from pathtracing_tpu_torch.scenes import sanmiguel_analog
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    desc = load_generator(ROOT, "sanmiguel_analog")(faithful=faithful,
                                                     **SMALL)
    s0, c0, m0 = sanmiguel_analog(faithful=faithful, device="cpu", **SMALL)
    s1, c1, m1 = replay(desc, SceneBuilder()).build(**desc.build_kwargs,
                                                    device="cpu")
    assert m0 == m1 and set(s0) == set(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in c0:
        assert k == "resolution" or torch.equal(c0[k], c1[k]), k
    # the reference's own tables (frozen builder, scan) hold the same rows
    s2, c2, m2 = replay(desc, RefBuilder()).build(accel="brute",
                                                  device="cpu")
    assert m2.accel == "brute" and m2.n_tri == m0.n_tri
    for k in s2:
        if k in s0:
            assert torch.equal(s0[k], s2[k]), k


def _run(cell="faithful-fwd-d64", seed=2 ** 31 + 77, **kw):
    return run_cell(cell, seed, 0.5, device="cpu", params=SMALL,
                    traffic_over=MIX, **kw)


@pytest.mark.parametrize("cell", ["faithful-fwd-d64", "legacy-fwd-d32",
                                  "instanced-fwd-d32"])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["info"]["bounces_checked"] > 50
    # the instanced cell's check judges answers on the instances
    assert (r["info"]["instanced_hits_checked"] > 0) \
        == (cell == "instanced-fwd-d32")
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"fwd_samples_per_s", "setup_s"}


def test_lower_precision_control_fails():
    # the control stands where the program's answers would, and the same
    # limits judge it
    r = _run(control="bf16")
    assert not r["correct"], r["checks"]
    assert r["info"]["control"] == "bf16"
    assert r["checks"]["shade_bad_share"]["value"] > 0.3


def test_sensor_reference_is_the_port_s_camera_and_film():
    """The independent camera, sampler and splat (reference/sensor.py)
    agree with what the port computes, at float32's rounding."""
    import math
    import numpy as np
    from rtbench.reference import sensor
    from pathtracing_tpu_torch.core.rng import SamplerConfig, sample_2d
    from pathtracing_tpu_torch.sensor.camera import camera_lanes
    from pathtracing_tpu_torch.sensor.film import new_film, splat
    from pathtracing_tpu_torch.core.filters import mitchell
    desc = load_generator(ROOT, "sanmiguel_analog")(faithful=True, **SMALL)
    cam = sensor.camera_of(desc)
    _, pcam, _ = replay(desc, RefBuilder()).build(accel="brute",
                                                  device="cpu")
    g = np.random.default_rng(3)
    w, h = cam["resolution"]
    n = 4000
    px, py = g.integers(0, w, n), g.integers(0, h, n)
    sidx = g.integers(0, 1 << 21, n)
    seed = (2 ** 31 + 77) & 0xFFFFFFFF
    cfg = SamplerConfig(kind="stratified", x_samples=4, y_samples=4,
                        seed=seed)
    sp = dict(kind="stratified", x_samples=4, y_samples=4, seed=seed)
    tpx, tpy, ts = (torch.as_tensor(x) for x in (px, py, sidx))
    for dim in (0, 3, 9):
        got = sample_2d(cfg, tpx, tpy, ts, dim).double().numpy()
        assert np.abs(got - sensor.sample2(sp, px, py, sidx, dim)).max() \
            < 1e-7
    o, d, _, p = camera_lanes(pcam, cfg, tpx, tpy, ts)
    o2, d2 = sensor.camera_rays(cam, sp, px, py, sidx)
    assert np.abs(o.double().numpy() - o2).max() < 1e-5
    assert np.abs(d.double().numpy() - d2).max() < 1e-6
    col = g.random((n, 3))
    film = splat(new_film((w, h), device="cpu"), mitchell(), (w, h), p,
                 torch.as_tensor(col, dtype=torch.float32))
    ref = sensor.Film((w, h))
    ref.splat(sensor.film_position(sp, px, py, sidx), col)
    assert float((film["rgb"].double() - ref.rgb).abs().max()) \
        < 1e-5 * float(ref.rgb.abs().max())
    assert math.isclose(float(film["weight"].sum()), float(ref.weight.sum()),
                        rel_tol=1e-5)


def _break(monkeypatch, fault):
    from pathtracing_tpu_torch.integrators import path, render
    if fault == "state_unchanged":
        orig = path._make_bounce

        def make_bounce(*a, **k):
            bounce = orig(*a, **k)

            def run(state, b):
                res = bounce(state, b)
                out = res[0] if isinstance(res, tuple) else res
                # the lane state comes back as it went in (alive kept off
                # so the drain still ends)
                out = dict(state, alive=out["alive"], n_rays=out["n_rays"],
                           t_hit=out["t_hit"])
                return (out, res[1]) if isinstance(res, tuple) else out
            return run
        monkeypatch.setattr(path, "_make_bounce", make_bounce)
    elif fault == "answer_altered":
        from pathtracing_tpu_torch.integrators import regen_diff
        for mod in (render, regen_diff):
            def trace_regen(*a, orig=mod._trace_regen, **k):
                out, st = orig(*a, **k)
                return out * 1.01, st
            monkeypatch.setattr(mod, "_trace_regen", trace_regen)
    elif fault == "half_batch":
        orig = render._trace_regen

        def trace_regen(scene, cam, meta, cfg, pixel_idx, waves, offset,
                        **k):
            half = pixel_idx[: pixel_idx.shape[0] // 2]
            out, st = orig(scene, cam, meta, cfg, half, waves, offset, **k)
            full = torch.zeros((pixel_idx.shape[0] * waves, 3))
            full[: out.shape[0]] = out
            return full, st
        monkeypatch.setattr(render, "_trace_regen", trace_regen)
    elif fault == "traversal_altered":
        orig = path._intersect

        def intersect(*a, **k):
            hit = orig(*a, **k)
            return dict(hit, t=hit["t"] * 1.05)
        monkeypatch.setattr(path, "_intersect", intersect)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_batch", "traversal_altered"])
def test_broken_timed_path_is_incorrect(monkeypatch, fault):
    _break(monkeypatch, fault)
    r = _run()
    assert not r["correct"], r["checks"]


def _run_grad(**kw):
    mix = {k: v for k, v in MIX.items() if k != "max_depth"}
    return run_cell("faithful-grad-d8", 2 ** 31 + 91, 0.5, device="cpu",
                    params=SMALL, traffic_over=mix, **kw)


def test_grad_step_is_correct_and_its_control_fails():
    r = _run_grad()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"grad_samples_per_s", "setup_s"}
    assert r["checks"]["grad_rel_err"]["value"] < 1e-5
    # only the checked step's records are kept
    assert r["info"]["drains_kept"] == [r["info"]["drains_kept"][0]]
    c = _run_grad(control="bf16")
    assert not c["correct"]
    assert c["checks"]["grad_rel_err"]["value"] \
        > c["checks"]["grad_rel_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_batch_backward"])
def test_broken_grad_step_is_incorrect(monkeypatch, fault):
    if fault == "half_batch_backward":
        from pathtracing_tpu_torch.integrators import regen_diff
        orig = regen_diff._replay

        def replay(*a, **k):
            tput, pp, rad, flush = orig(*a, **k)
            keep = torch.arange(flush.shape[0]) % 2 == 0
            # half the lanes' samples left out of the backward, the rest
            # counted twice (the mean over what is left)
            return tput, pp, rad, torch.where(keep[:, None], 2 * flush, 0.0)
        monkeypatch.setattr(regen_diff, "_replay", replay)
    else:
        _break(monkeypatch, fault)
    r = _run_grad()
    assert not r["correct"], r["checks"]
