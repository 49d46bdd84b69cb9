"""The port's API walkthrough (pathtracing_tpu_torch/tools/example_1.py)
against examples/example_1.py.

The JAX scene is built by executing the example's own source up to its
`scene, cam, meta = b.build()` line (without it), so the test follows the
example file as it stands; the camera is then set again with the same
arguments at a tiny resolution.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.tools import example_1

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_1.py"
RES = (16, 12)


def _jax_example_scene(resolution):
    src = EXAMPLE.read_text()
    stop = src.index("scene, cam, meta = b.build()")
    ns = {}
    exec(compile(src[:stop], str(EXAMPLE), "exec"), ns)
    b = ns["b"]
    c = b.camera
    b.set_camera(c["look_from"], c["look_at"], c["fov"], resolution,
                 focus_angle=c["focus_angle"],
                 focus_distance=c["focus_distance"])
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    return _jax_example_scene(RES), example_1.build_scene(RES, "cpu")


def _assert_same(name, want, got):
    want = np.asarray(want)
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    assert got.shape == want.shape, name
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=name)


def test_torch_example_scene_matches_jax_example(scenes):
    (js, jc, jm), (ts, tc, tm) = scenes
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.accel == "brute" and tm.n_sph == 4 and tm.n_quad == 2
    # the port keeps no velocity arrays for a static scene
    for k in set(js) - set(ts):
        assert k.endswith("_vel") and not np.asarray(js[k]).any(), k
    assert set(ts) <= set(js)
    for k in sorted(ts):
        _assert_same(k, js[k], ts[k])
    assert set(tc) == set(jc) and tc["resolution"] == jc["resolution"] == RES
    for k in sorted(tc):
        _assert_same(k, jc[k], tc[k])


def test_torch_example_render_matches_jax_example(scenes):
    """16x12, 4 spp, volpath depth 8, the example's 8x8 sampler (seed 0):
    the 99% image rule (tests/test_bvh.py:276-277)."""
    (js, jc, jm), (ts, tc, tm) = scenes
    cfg = example_1.render_config(spp=4, depth=8)
    jcfg = JConfig(spp=4, max_depth=8, integrator="volpath",
                   sampler=JSampler(x_samples=8, y_samples=8, seed=0))
    assert (cfg.integrator, cfg.sampler.x_samples, cfg.sampler.y_samples,
            cfg.sampler.seed) == ("volpath", 8, 8, 0)
    want = np.asarray(j_render(js, jc, jm, jcfg))
    got = t_render(ts, tc, tm, cfg, device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, (close.mean(), np.abs(got - want).max())


def test_torch_example_main_writes_ppm(tmp_path, monkeypatch):
    out = tmp_path / "ex.ppm"
    res = example_1.main(["--device", "cpu", "--res", "8", "6", "--spp", "2",
                          "--out", str(out)])
    data = out.read_bytes()
    header = b"P6\n8 6\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 8 * 6 * 3
    img = res["film"]["rgb"] / res["film"]["weight"][:, None]
    assert img.shape == (8 * 6, 3) and torch.isfinite(img).all()
    assert res["resolution"] == (8, 6) and res["seconds"] > 0
    # the grid grows past 64 spp so no sample index passes the strata
    for spp, side in ((1, 8), (64, 8), (65, 9), (100, 10)):
        s = example_1.render_config(spp).sampler
        assert (s.x_samples, s.y_samples) == (side, side), spp
    # without Pillow a .png is refused before rendering, naming the PPM way
    monkeypatch.setitem(sys.modules, "PIL", None)
    png = tmp_path / "ex.png"
    with pytest.raises(RuntimeError, match=r"--out x\.ppm"):
        example_1.main(["--device", "cpu", "--res", "8", "6", "--spp", "2",
                        "--out", str(png)])
    assert not png.exists()
