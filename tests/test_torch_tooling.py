"""pathtracing_tpu_torch's render tooling (utils/) against the JAX
package's: checkpoint / resume bit-identical to one uninterrupted render,
Welford statistics against NumPy, adaptive sampling with the JAX spp map
and film, RenderTimer's metrics line and the torch.profiler trace."""
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.sensor.film import finalize as j_finalize
from pathtracing_tpu.utils import adaptive as jadaptive
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render
from pathtracing_tpu_torch.sensor.film import finalize
from pathtracing_tpu_torch.utils import adaptive, checkpoint
from pathtracing_tpu_torch.utils.profile import RenderTimer, trace_to

torch.set_num_threads(2)


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_checkpoint_resume_bit_identical(tmp_path, regenerate):
    """4 samples, an interruption, then a resume to 8 (checkpoints every
    2): the film is bit-identical to one uninterrupted 8-sample render."""
    scene, cam, meta = tscenes.furnace(resolution=(16, 16), device="cpu")
    cfg = TConfig(spp=8, max_depth=3, regenerate=regenerate)
    straight = render(scene, cam, meta, cfg, spp=8, device="cpu")
    ckpt = tmp_path / "ck.npz"
    checkpoint.render_with_checkpoints(scene, cam, meta, cfg, 4, ckpt,
                                       every=2, device="cpu")
    film, done, seed, res, _ = checkpoint.load_checkpoint(ckpt, device="cpu")
    assert (done, seed, res) == (4, cfg.sampler.seed, (16, 16))
    f2 = checkpoint.render_with_checkpoints(scene, cam, meta, cfg, 8, ckpt,
                                            every=2, device="cpu")
    assert torch.equal(f2["rgb"], straight["rgb"])
    assert torch.equal(f2["weight"], straight["weight"])
    with pytest.raises(ValueError):      # another render's checkpoint
        checkpoint.render_with_checkpoints(
            scene, cam, meta, dataclasses.replace(
                cfg, sampler=dataclasses.replace(cfg.sampler, seed=9)),
            8, ckpt, device="cpu")


def test_torch_welford_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (20, 5, 3)).astype(np.float32)
    masks = rng.uniform(0, 1, (20, 5)) < 0.8
    st = adaptive.welford_init(5, device="cpu")
    jst = jadaptive.welford_init(5)
    for x, m in zip(xs, masks):
        st = adaptive.welford_add(st, torch.from_numpy(x),
                                  torch.from_numpy(m))
        jst = jadaptive.welford_add(jst, jnp.asarray(x), jnp.asarray(m))
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, atol=1e-7)
    for p in range(5):
        sel = xs[masks[:, p], p]
        np.testing.assert_allclose(st["mean"][p].numpy(), sel.mean(0),
                                   rtol=1e-5)
        np.testing.assert_allclose(st["m2"][p].numpy() / (len(sel) - 1),
                                   sel.var(0, ddof=1), rtol=1e-4)
    rel = adaptive.relative_variance(st).numpy()
    np.testing.assert_allclose(rel, np.asarray(
        jadaptive.relative_variance(jst)), rtol=1e-5)
    assert rel.shape == (5,) and np.isfinite(rel).all()


_ADAPTIVE = dict(base_spp=4, target=1.5, max_factor=3, bucket_floor=100)


@pytest.fixture(scope="module")
def jax_adaptive():
    """The JAX package's adaptive render of the 10x10 Cornell box (one
    batch shape: bucket_floor covers the frame)."""
    return jadaptive.render_adaptive(
        *jscenes.cornell_box(resolution=(10, 10)),
        JConfig(spp=4, max_depth=3, rays_per_batch=128), **_ADAPTIVE)


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_adaptive_matches_jax(jax_adaptive, regenerate):
    """render_adaptive, waves through render_tile or (regenerate=True)
    render_tile_regen: the same per-pixel sample counts and traced samples
    as the JAX package's wave render (padding slots at pixel H*W
    dropped), the film by the 99% rule."""
    jf, js = jax_adaptive
    tf, ts = adaptive.render_adaptive(
        *tscenes.cornell_box(resolution=(10, 10), device="cpu"),
        TConfig(spp=4, max_depth=3, rays_per_batch=128,
                regenerate=regenerate), device="cpu", **_ADAPTIVE)
    np.testing.assert_array_equal(ts["spp_map"], js["spp_map"])
    assert ts["traced_samples"] == js["traced_samples"]
    assert 4 <= ts["mean_spp"] < 12 and len(np.unique(ts["spp_map"])) > 1
    got = finalize(tf).numpy()
    want = np.asarray(j_finalize(jf))
    assert np.isfinite(got).all()
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).mean() > 0.99


def test_torch_adaptive_traces_active_pixels_only():
    """Converged pixels stop costing samples: with the JAX test's
    settings (24x24 Cornell box, bucket_floor=16), fewer samples are traced
    than a uniform render at the highest per-pixel count."""
    _, st = adaptive.render_adaptive(
        *tscenes.cornell_box(resolution=(24, 24), device="cpu"),
        TConfig(spp=4, max_depth=3, regenerate=True), base_spp=4,
        target=1.5, max_factor=8, bucket_floor=16, device="cpu")
    assert st["traced_samples"] < 24 * 24 * int(st["spp_map"].max())


def test_torch_render_timer_and_trace(tmp_path):
    """RenderTimer prints one JSON line with the JAX package's keys;
    trace_to writes a Chrome trace of the block with the program's spans
    in it, on the trace's time base: the item's span over the operations
    its thread ran."""
    scene, cam, meta = tscenes.furnace(resolution=(8, 8), device="cpu")
    cfg = TConfig(spp=2, max_depth=2, regenerate=True)
    out = io.StringIO()
    with trace_to(tmp_path / "prof"):
        with RenderTimer(64, 2, 2, stream=out) as t:
            t.result = render(scene, cam, meta, cfg, device="cpu")
    m = json.loads(out.getvalue())
    assert m == t.metrics
    assert set(m) == {"label", "wall_s", "camera_samples", "samples_per_s",
                      "max_rays_per_s", "n_devices"}
    assert m["camera_samples"] == 128 and m["samples_per_s"] > 0
    assert m["n_devices"] == 1
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    names = {e["name"] for e in ours}
    assert {"wavefront.item", "wavefront.iteration", "film.splat",
            "shading.interaction", "shading.material", "shading.bsdf",
            "shading.lights", "intersect.shadow"} <= names
    item = next(e for e in ours if e["name"] == "wavefront.item")
    ops = [e for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op" and e.get("tid") == item["tid"]
           and str(e.get("name", "")).startswith("aten::")]
    inside = [e for e in ops if item["ts"] <= e["ts"]
              and e["ts"] + e.get("dur", 0) <= item["ts"] + item["dur"]]
    assert len(inside) > len(ops) // 2 > 0
