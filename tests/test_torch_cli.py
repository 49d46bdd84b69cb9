"""pathtracing_tpu_torch's command line (python -m pathtracing_tpu_torch)
on the CPU: a model import reaches the traversal tables and prints
RenderTimer's JSON line (the counterpart of tests/test_tooling.py:100-145),
the scene cache's second run renders the same film, --checkpoint,
--adaptive, --profile and the built-in scenes (every one of the JAX
package's SCENES, `--scene medium --integrator volpath` included)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.__main__ import main

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _grid_obj(path, side=50):
    """(side - 1)^2 * 2 triangles: 4,802 for side 50, above the 4,096
    prims at which accel="auto" takes the traversal tables."""
    with path.open("w") as f:
        for i in range(side):
            for j in range(side):
                f.write(f"v {i * 0.1} {0.02 * math.sin(i + j)} {j * 0.1}\n")
        for i in range(side - 1):
            for j in range(side - 1):
                a = i * side + j + 1
                b, c = a + 1, a + side
                f.write(f"f {a} {b} {c}\nf {b} {c + 1} {c}\n")
    return path


_MODEL_ARGS = ["--resolution", "16", "16", "--spp", "1", "--max-depth", "2",
               "--env-light", "1.0", "--sun", "2", "--look-from",
               "2.5,3,-2", "--look-at", "2.5,0,2.5"]


def test_torch_cli_model_import_reaches_the_kernel_tables(tmp_path):
    obj = _grid_obj(tmp_path / "grid.obj")
    out = tmp_path / "img.ppm"
    cp = subprocess.run(
        [sys.executable, "-m", "pathtracing_tpu_torch", "render",
         "--device", "cpu", "--model", str(obj), *_MODEL_ARGS,
         "--out", str(out)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert "accel=pallas" in cp.stderr, cp.stderr[-2000:]
    assert out.read_bytes().startswith(b"P6\n16 16\n255\n")
    line = [ln for ln in cp.stderr.splitlines()
            if '"samples_per_s"' in ln][-1]
    m = json.loads(line[line.index("{"):])
    assert m["samples_per_s"] > 0 and m["camera_samples"] == 256
    assert m["n_devices"] == 1


def test_torch_cli_profile_traces_the_build_and_the_render(tmp_path):
    """render --profile DIR traces the scene build as well as the render:
    its Chrome trace holds the build's spans and the drain's."""
    obj = _grid_obj(tmp_path / "grid.obj")
    prof = tmp_path / "prof"
    r = main(["render", "--device", "cpu", "--model", str(obj), *_MODEL_ARGS,
              "--regen", "--profile", str(prof), "--out",
              str(tmp_path / "img.ppm")])
    assert r["metrics"]["samples_per_s"] > 0
    trace = json.loads((prof / "trace.json").read_text())
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    names = {e["name"] for e in ours}
    assert {"build.tables", "build.upload", "wavefront.item",
            "wavefront.iteration", "film.splat"} <= names
    first = {n: min(e["ts"] for e in ours if e["name"] == n) for n in names}
    assert first["build.upload"] < first["wavefront.item"]


def test_torch_cli_cache_second_run_bit_equal(tmp_path):
    """--cache: the first run builds and writes the cache, the second
    loads it (no import, no build) and renders the same film."""
    obj = _grid_obj(tmp_path / "grid.obj", side=20)
    args = ["render", "--device", "cpu", "--model", str(obj), *_MODEL_ARGS,
            "--cache", str(tmp_path / "c.npz"), "--regen", "--out",
            str(tmp_path / "a.ppm")]
    r1 = main(args)
    r2 = main(args)
    assert {"import_s", "build_s", "cache_save_s", "render_s"} <= set(
        r1["times"])
    assert "cache_load_s" in r2["times"] and "build_s" not in r2["times"]
    assert r2["meta"] == r1["meta"]
    for k in ("rgb", "weight"):
        assert torch.equal(r2["film"][k], r1["film"][k])


def test_torch_cli_checkpoint_and_adaptive(tmp_path):
    base = ["render", "--device", "cpu", "--scene", "furnace",
            "--resolution", "8", "8", "--max-depth", "2", "--out",
            str(tmp_path / "f.ppm")]
    ck = tmp_path / "ck.npz"
    # an interrupted run of the render the CLI configures for --spp 4:
    # two of its four samples checkpointed
    from pathtracing_tpu_torch import RenderConfig, SamplerConfig
    from pathtracing_tpu_torch.utils.checkpoint import render_with_checkpoints
    cfg = RenderConfig(spp=4, max_depth=2, sampler=SamplerConfig(
        kind="stratified", x_samples=2, y_samples=2, seed=0))
    render_with_checkpoints(*tscenes.furnace(resolution=(8, 8), device="cpu"),
                            cfg, 2, ck, every=1, device="cpu")
    resumed = main(base + ["--spp", "4", "--checkpoint", str(ck),
                           "--checkpoint-every", "1"])
    straight = main(base + ["--spp", "4"])
    assert torch.equal(resumed["film"]["rgb"], straight["film"]["rgb"])
    adaptive = main(base + ["--spp", "32", "--adaptive", "1.5"])
    assert torch.isfinite(adaptive["film"]["rgb"]).all()


def test_torch_cli_volpath_medium_scene(tmp_path):
    """README's `--scene medium --integrator volpath`."""
    out = tmp_path / "m.ppm"
    r = main(["render", "--device", "cpu", "--scene", "medium",
              "--integrator", "volpath", "--resolution", "12", "12",
              "--spp", "1", "--max-depth", "3", "--out", str(out)])
    assert r["meta"].n_media == 2 and out.exists()
    assert torch.isfinite(r["film"]["rgb"]).all()


def test_torch_scenes_cover_the_jax_scenes():
    """Every key of the JAX package's SCENES is in the port's, and builds
    on the CPU with the JAX scene's counts."""
    assert set(jscenes.SCENES) <= set(tscenes.SCENES)
    small = dict(sanmiguel_analog=dict(n_tris=2_000, foliage=4),
                 mat_test=dict(rows=2, cols=3))
    for name in sorted(jscenes.SCENES):
        kw = dict(resolution=(8, 8), **small.get(name, {}))
        _, _, tm = tscenes.SCENES[name](device="cpu", **kw)
        _, _, jm = jscenes.SCENES[name](**kw)
        assert (tm.n_tri, tm.n_sph, tm.n_quad, tm.n_lights, tm.n_media) == \
            (jm.n_tri, jm.n_sph, jm.n_quad, jm.n_lights, jm.n_media), name


def test_torch_cli_refusals(tmp_path, monkeypatch, capsys):
    """What the port refused until it had them: `bench` runs the bench
    (pathtracing_tpu_torch/bench.py, here at a tiny BENCH_FAST size) and
    prints its JSON line; --accel bvh renders through the wide-BVH walk,
    the image equal to the brute scan's."""
    for k, v in dict(BENCH_FAST="1", N_TRIS="1500", BENCH_FOLIAGE="4",
                     BENCH_DEPTH="2", BENCH_REPS="1").items():
        monkeypatch.setenv(k, v)
    out = main(["bench", "--device", "cpu", "--res", "16", "8",
                "--cornell-res", "8", "--cornell-spp", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out and out["value"] > 0
    obj = _grid_obj(tmp_path / "g.obj", side=4)
    films = {}
    for accel in ("bvh", "brute"):
        r = main(["render", "--device", "cpu", "--model", str(obj),
                  "--accel", accel, "--out", str(tmp_path / f"{accel}.ppm")]
                 + _MODEL_ARGS)
        assert r["meta"].accel == accel
        assert (tmp_path / f"{accel}.ppm").exists()
        films[accel] = r["film"]["rgb"]
    assert float(films["bvh"].mean()) > 0
    torch.testing.assert_close(films["bvh"], films["brute"], rtol=1e-4,
                               atol=1e-5)
