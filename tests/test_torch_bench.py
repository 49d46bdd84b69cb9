"""The port's bench (pathtracing_tpu_torch/bench.py), its bound count
(tools/roofline.py) and its golden run (tools/golden_run.py) on the CPU:
the forward frame and the rays run against the root bench.py's on the same
scenes (the JAX brute build carried across: the brute scan in both
packages), main() at a tiny size with every key of the JSON line, the
CLI's `bench`, the bound's operation and byte count on hand-made counters,
and the golden run's outputs and resume."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu_torch import bench as tbench, convert
from pathtracing_tpu_torch.__main__ import main as cli_main
from pathtracing_tpu_torch.scenes import cornell_box, sanmiguel_analog
from pathtracing_tpu_torch.sensor import film as filmmod
from pathtracing_tpu_torch.tools import golden_run, roofline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

SECONDARY = ("derived_rays_per_sec_mesh10M", "rays_per_camera_sample",
             "trace_rays_per_sec_frame_sampled",
             "camera_samples_per_sec_legacy_gentle_1080p_d32",
             "vs_baseline_legacy_gentle",
             "camera_samples_per_sec_cornell_512_path_d8",
             "vs_baseline_cornell")
KERNEL_KEYS = ("bounce_ms_64k", "l1_visits_per_ray", "leaf_blocks_per_ray",
               "top_slab_tests_per_ray", "bounce_bound_ms_64k",
               "bounce_bound_by")


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py (the JAX package's bench), loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(scene, cam, meta):
    return convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)},
        device="cpu")


@pytest.mark.parametrize("faithful,depth", [(True, 1), (False, 8)])
def test_torch_bench_forward_matches_jax(jbench, monkeypatch, faithful,
                                         depth):
    """bench_mesh_forward's film on a tiny sanmiguel_analog (2,000 terrain
    triangles, 32x24) against the root bench.py's on the same scene and
    sample offsets (BENCH_REPS=2: the last timed frame is sample_offset
    2): > 99% of values within rtol=1e-4, atol=1e-5.  The faithful scene
    (8 shrubs, textures, normal map) at depth 1: its normal map turns
    one-ulp hit differences into other paths a bounce later, so its
    agreement at depth 2 is 97.9-99.4% by frame (tests/test_torch_render.py
    holds its renders at depth 2); the untextured legacy scene at depth 8
    (measured 100%)."""
    monkeypatch.setenv("BENCH_REPS", "2")
    js, jc, jm = jscenes.sanmiguel_analog(resolution=(32, 24), n_tris=2_000,
                                          foliage=8, faithful=faithful,
                                          accel="brute")
    _, jfilm = jbench.bench_mesh_forward(js, jc, jm, (32, 24), 1, depth,
                                         None, True)
    want = np.asarray(jfilm["rgb"]) / np.maximum(
        np.asarray(jfilm["weight"]), 1e-12)[..., None]
    scene, cam, meta = _carry(js, jc, jm)
    stats = {}
    rate, film = tbench.bench_mesh_forward(scene, cam, meta, (32, 24), 1,
                                           depth, None, True, warm=False,
                                           stats=stats)
    got = filmmod.finalize(film).numpy()
    assert rate > 0 and stats["iterations"] > 0 and stats["n_rays"] > 0
    assert np.isfinite(want).all() and want.mean() > 0.01
    close = np.isclose(got.reshape(want.shape), want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, close.mean()


def test_torch_bench_rays_matches_jax(jbench):
    """bench_mesh_rays' rays per camera sample (one regenerating drain of
    65,536 lanes over the frame's 256 rows, depth 2) on a small legacy
    sanmiguel_analog equals the root bench.py's to rtol=1e-3."""
    js, jc, jm = jscenes.sanmiguel_analog(resolution=(256, 256), n_tris=400,
                                          faithful=False, accel="brute")
    want, _ = jbench.bench_mesh_rays(js, jc, jm, 2, True)
    got, rate = tbench.bench_mesh_rays(*_carry(js, jc, jm), 2, True,
                                       warm=False)
    assert rate > 0 and 2.0 < got < 4.0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def _tiny_env(monkeypatch, **extra):
    for k, v in dict(N_TRIS="1500", BENCH_FOLIAGE="4", BENCH_DEPTH="2",
                     BENCH_REPS="1", **extra).items():
        monkeypatch.setenv(k, v)


TINY_ARGS = ["--device", "cpu", "--res", "20", "12", "--cornell-res", "8",
             "--cornell-spp", "1"]


def test_torch_bench_main_prints_every_key(monkeypatch, capsys):
    """main() at a tiny size (1,500 terrain triangles, 4 shrubs, 20x12,
    depth 2, one timed repetition, the legacy frame included): its last
    line parses and has the primary metric and every secondary key; the
    bounce kernel's keys are absent off the card and without two-level
    tables, as the root bench.py omits them without them."""
    _tiny_env(monkeypatch)
    out = tbench.main(TINY_ARGS)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert out["metric"] == "camera_samples_per_sec_mesh10M_1080p_path_d2"
    assert out["unit"] == "samples/s" and out["value"] > 0
    assert out["vs_baseline"] == round(
        out["value"] / tbench.BASELINE_SAMPLES_PER_S, 4)
    sec = out["secondary"]
    want = set(SECONDARY) | {"fwd_bwd_samples_per_sec_mesh10M_12p_d8",
                             "fwd_bwd_samples_per_sec_mesh10M_12p_d2"}
    assert set(sec) == want
    rates = {k for k in want if not k.startswith("vs_baseline")}
    assert all(sec[k] > 0 for k in rates), sec
    assert sec["vs_baseline_cornell"] == round(
        sec["camera_samples_per_sec_cornell_512_path_d8"]
        / tbench.BASELINE_SAMPLES_PER_S, 3)
    assert not set(KERNEL_KEYS) & set(sec)


def test_torch_bench_cli_runs_cmd_bench(monkeypatch, capsys):
    """`python -m pathtracing_tpu_torch bench --device cpu` goes through
    cmd_bench to the bench (BENCH_FAST: no legacy frame and no fwd+bwd at
    the frame's depth, both keys 0.0 as in the root bench.py; the scan
    fwd+bwd form)."""
    _tiny_env(monkeypatch, BENCH_FAST="1", BENCH_BWD_FORM="scan")
    out = cli_main(["bench"] + TINY_ARGS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    sec = out["secondary"]
    assert sec["camera_samples_per_sec_legacy_gentle_1080p_d32"] == 0.0
    assert sec["fwd_bwd_samples_per_sec_mesh10M_12p_d8"] > 0
    assert sec["fwd_bwd_samples_per_sec_mesh10M_12p_d2"] == 0.0


def test_torch_bench_frame_takes_the_callers_config():
    """bench_frame renders under the caller's RenderConfig: a path frame
    equals bench_mesh_forward's at the same settings, and a volpath frame
    with another sampler seed is that integrator's render at
    sample_offset spp (one timed repetition, no warm frame)."""
    from pathtracing_tpu_torch.integrators.path import RenderConfig
    from pathtracing_tpu_torch.integrators.render import render
    from pathtracing_tpu_torch import SamplerConfig
    from pathtracing_tpu_torch.scenes import spheres_medium
    scene, cam, meta = cornell_box(resolution=(12, 8), device="cpu")
    _, want = tbench.bench_mesh_forward(scene, cam, meta, (12, 8), 2, 3,
                                        None, True, reps=1, warm=False)
    cfg = RenderConfig(spp=2, max_depth=3, integrator="path",
                       rays_per_batch=tbench.LANES, regenerate=True)
    rate, got = tbench.bench_frame(scene, cam, meta, cfg, reps=1,
                                   warm=False)
    assert rate > 0 and torch.equal(got["rgb"], want["rgb"])
    scene, cam, meta = spheres_medium(resolution=(12, 8), device="cpu")
    cfg = RenderConfig(spp=1, max_depth=4, integrator="volpath",
                       sampler=SamplerConfig(seed=7), regenerate=True)
    stats = {}
    _, got = tbench.bench_frame(scene, cam, meta, cfg, reps=1, warm=False,
                                stats=stats)
    want = render(scene, cam, meta, cfg, sample_offset=1, device="cpu")
    assert torch.equal(got["rgb"], want["rgb"]) and stats["n_rays"] > 0


def test_torch_bench_grad_first_queue_groups(monkeypatch):
    """tools/bench_grad.fwd_bwd_regen over the first queue group only:
    that group's radiance and forward launches equal the whole frame's
    first group's, and its rate counts that group's samples."""
    from pathtracing_tpu_torch.tools import bench_grad
    monkeypatch.setattr(bench_grad, "LANES", 32)
    scene, cam, meta = sanmiguel_analog(resolution=(8, 80), n_tris=1_500,
                                        foliage=4, device="cpu")
    groups, waves = bench_grad.regen_groups(cam)
    assert len(groups) > 1
    full = bench_grad.fwd_bwd_regen(scene, cam, meta, 2)
    first = bench_grad.fwd_bwd_regen(scene, cam, meta, 2, n_groups=1)
    assert first["groups"] == 1 and full["groups"] == len(groups)
    assert torch.equal(first["outs"][0], full["outs"][0])
    assert first["launches_fwd_by_group"] == full["launches_fwd_by_group"][:1]
    n = (groups[0][1] - groups[0][0]) * waves
    assert first["samples_per_s"] * first["seconds"] == pytest.approx(n)
    assert first["finite"] and float(first["grad"].abs().sum()) > 0


def test_torch_bench_scheduling_form(monkeypatch):
    """scheduling_form: regeneration by default, BENCH_REGEN=0 plain
    waves, BENCH_COMPACT=n compaction (exclusive with regeneration)."""
    for k in ("BENCH_REGEN", "BENCH_COMPACT"):
        monkeypatch.delenv(k, raising=False)
    assert tbench.scheduling_form() == (None, True)
    monkeypatch.setenv("BENCH_REGEN", "0")
    assert tbench.scheduling_form() == (None, False)
    monkeypatch.setenv("BENCH_REGEN", "1")
    monkeypatch.setenv("BENCH_COMPACT", "6")
    assert tbench.scheduling_form() == (6, False)


def test_torch_bench_bounce_kernel_needs_the_card():
    """The bounce row comes from K1's counters: {} on CPU tensors and on
    single-level tables."""
    scene, _, meta = sanmiguel_analog(resolution=(8, 8), n_tris=1_500,
                                      foliage=4, faithful=False,
                                      accel="pallas", device="cpu")
    assert tbench.bench_bounce_kernel(scene, meta, n=64) == {}


def _two_level(m1=20, g=4, k2=8, inst=False):
    """Table shapes of a two-level set (only their sizes matter)."""
    sc = dict(pk_l1box=torch.zeros(m1, 8), pk_l2box=torch.zeros(m1 * g, 8),
              pk_l1_base=torch.zeros(m1), pk_tri=torch.zeros(m1 * g * k2, 12))
    if inst:
        sc["pk_blk_src"] = torch.tensor([i % 3 for i in range(m1)])
    return sc


def test_torch_roofline_two_level_count():
    """traversal_bound on hand-made K1 counters: operations = top slab
    tests x 20 + L1 visits x G x 20 + leaf blocks x K x 45 + mask lookups
    x 20; bytes = rays (36 B, + 4 timed) + the top level (36 B per entry,
    32 per coarse union of 8) + G x 32 B per visited L1 + K x 48 B per
    visited block + 32 B per lookup; the bound the larger time."""
    sc = _two_level()
    n = 4
    cnt = torch.tensor([[1, 2, 3, 0, 10]] * 3 + [[2, 4, 6, 8, 30]],
                       dtype=torch.int32)
    l1 = torch.zeros(20, dtype=torch.bool)
    l1[:5] = True
    leaf = torch.zeros(80, dtype=torch.bool)
    leaf[:7] = True
    res = dict(counters=cnt, l1_touched=l1, leaf_touched=leaf)
    b = roofline.traversal_bound(sc, res, n, timed=True)
    flops = 60 * 20 + 10 * 4 * 20 + 15 * 8 * 45 + 8 * 20
    nbytes = n * 40 + 20 * 36 + 3 * 32 + 5 * 4 * 32 + 7 * 8 * 48 + 8 * 32
    assert b["flops"] == flops and b["bytes"] == nbytes
    assert b["ops_ms"] == pytest.approx(flops / roofline.FP32_PEAK * 1e3)
    assert b["bytes_ms"] == pytest.approx(nbytes / roofline.HBM_RATE * 1e3)
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])
    assert b["bound_by"] == "bytes"
    assert b["per_ray"] == dict(top_refills=1.25, l1_visits=2.5,
                                leaf_blocks=3.75, mask_lookups=2.0,
                                top_slab_tests=15.0)
    # instanced: + 4 B per ray, + 8 B per entry, physical L1s counted once,
    # + 48 B per visited expanded entry
    si = _two_level(inst=True)
    bi = roofline.traversal_bound(si, res, n)
    assert bi["bytes"] == (n * 40 + 20 * 44 + 3 * 32 + 3 * 4 * 32 + 5 * 48
                           + 7 * 8 * 48 + 8 * 32)
    # many leaf tests: operations bound
    heavy = dict(res, counters=cnt * 1000)
    assert roofline.traversal_bound(sc, heavy, n)["bound_by"] == \
        "operations"


def test_torch_roofline_single_level_count():
    """traversal_bound on hand-made K2 counters, with the flat-scan bound
    (front refills x M slab tests in place of the counted ones)."""
    m, k, nc = 16, 8, 2
    sc = dict(pk_blkbox=torch.zeros(m, 8), pk_tri=torch.zeros(m, k, 12),
              pk_cbox=torch.zeros(nc, 8))
    cnt = torch.tensor([[2, 5, 5, 1, 9], [4, 3, 3, 3, 11]],
                       dtype=torch.int32)
    touched = torch.zeros(m, dtype=torch.bool)
    touched[:6] = True
    b = roofline.traversal_bound(sc, dict(counters=cnt,
                                          blocks_touched=touched), 2)
    leaf = 8 * k * 45 + 4 * 20
    flops = 20 * 20 + leaf
    nbytes = 2 * 36 + m * 32 + nc * 32 + 6 * k * 48 + 4 * 32
    assert b["flops"] == flops and b["bytes"] == nbytes
    flat = max((6 * m * 20 + leaf) / roofline.FP32_PEAK,
               (nbytes - nc * 32) / roofline.HBM_RATE) * 1e3
    assert b["bound_ms_flat_scan"] == pytest.approx(flat)
    assert b["per_ray"]["blocks_visited"] == 4.0


def test_torch_golden_run_writes_and_resumes(tmp_path):
    """golden_run.run at a tiny size (the Cornell box, 12x12, depth 3):
    the image, the progress and summary JSON; interrupted after its first
    checkpoint and run again, it resumes (resumed_from_spp 2) and its film
    is bit-equal to an uninterrupted run's; the depth-128 probe frame is
    finite."""
    scene, cam, meta = cornell_box(resolution=(12, 12), device="cpu")
    full = golden_run.run(scene, cam, meta, 4, 3, tmp_path / "a", every=2)
    assert full["status"] == "complete" and full["resumed_from_spp"] == 0
    assert full["spp"] == 4 and full["image_mean"] > 0
    assert Path(full["images"][0]).exists()
    summary = json.loads((tmp_path / "a" / "golden_run.json").read_text())
    assert summary == {k: v for k, v in full.items() if k != "film"}
    prog = json.loads((tmp_path / "a" / "golden_progress_4spp.json")
                      .read_text())
    assert prog["spp_done"] == 4 and prog["status"] == "in_progress"
    assert full["steady_samples_per_s"] > 0

    class Stop(Exception):
        pass

    def stop(done, total):
        raise Stop

    with pytest.raises(Stop):
        golden_run.run(scene, cam, meta, 4, 3, tmp_path / "b", every=2,
                       progress=stop)
    resumed = golden_run.run(scene, cam, meta, 4, 3, tmp_path / "b", every=2)
    assert resumed["resumed_from_spp"] == 2
    for k in ("rgb", "weight"):
        assert torch.equal(resumed["film"][k], full["film"][k]), k
    probe = golden_run.probe_d128(scene, cam, meta)
    assert np.isfinite(probe["mean"]) and probe["seconds"] > 0
