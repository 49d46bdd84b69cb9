"""Parity of pathtracing_tpu_torch's core modules with the JAX package:
RNG (bit-exact), camera rays, film splats, BSDFs and lights.  Inputs are
made from a seed with numpy and handed to both packages."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.core import bsdf as jb
from pathtracing_tpu.core import rng as jr
from pathtracing_tpu.core.filters import mitchell as j_mitchell
from pathtracing_tpu.scene import lights as jl
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu.sensor import camera as jc
from pathtracing_tpu.sensor import film as jf
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch.core import bsdf as tb
from pathtracing_tpu_torch.core import rng as tr
from pathtracing_tpu_torch.core.filters import mitchell as t_mitchell
from pathtracing_tpu_torch.scene import lights as tl
from pathtracing_tpu_torch.sensor import camera as tc
from pathtracing_tpu_torch.sensor import film as tf

torch.set_num_threads(2)

_SAMPLERS = [(4, 2, 11, "stratified"), (3, 3, 5, "stratified"),
             (4, 4, 0, "stratified"), (1, 1, 7, "uniform")]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cfgs(xs, ys, seed, kind):
    return (jr.SamplerConfig(kind=kind, x_samples=xs, y_samples=ys,
                             seed=seed),
            tr.SamplerConfig(kind=kind, x_samples=xs, y_samples=ys,
                             seed=seed))


def test_torch_rng_mix_and_hash_bit_equal():
    rs = np.random.default_rng(0)
    x = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    y = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jr.mix32(jnp.asarray(x))).astype(np.int64),
        tr.mix32(_t(x.astype(np.int64))).numpy())
    for args in [(x,), (x, y), (x, 7, y, 0xDEADBEEF)]:
        ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
        ta = [_t(a.astype(np.int64)) if isinstance(a, np.ndarray) else a
              for a in args]
        np.testing.assert_array_equal(
            np.asarray(jr.hash_u32(*ja)).astype(np.int64),
            tr.hash_u32(*ta).numpy())
        np.testing.assert_array_equal(np.asarray(jr.hash_float(*ja)),
                                      tr.hash_float(*ta).numpy())


@pytest.mark.parametrize("xs,ys,seed,kind", _SAMPLERS)
def test_torch_rng_samplers_bit_equal(xs, ys, seed, kind):
    jcfg, tcfg = _cfgs(xs, ys, seed, kind)
    rs = np.random.default_rng(seed)
    px = rs.integers(0, 1920, 2048)
    py = rs.integers(0, 1080, 2048)
    si = rs.integers(0, jcfg.spp, 2048)     # sample indices are < spp
    for dim in (0, 3, 21, 517):
        j1 = jr.sample_1d(jcfg, jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(si, jnp.uint32), dim)
        t1 = tr.sample_1d(tcfg, _t(px), _t(py), _t(si), dim)
        np.testing.assert_array_equal(np.asarray(j1), t1.numpy())
        j2 = jr.sample_2d(jcfg, jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(si, jnp.uint32), dim)
        t2 = tr.sample_2d(tcfg, _t(px), _t(py), _t(si), dim)
        np.testing.assert_array_equal(np.asarray(j2), t2.numpy())


def _camera_pair(focus_angle=0.0):
    b = JBuilder()
    b.add_sphere([0, 0, 0], 1.0, material=b.add_diffuse())
    b.set_camera([1.0, 2.0, -7.0], [0.2, 0.5, 0.0], math.radians(45),
                 (48, 32), focus_angle=focus_angle, focus_distance=6.5)
    scene, cam, meta = b.build(accel="brute")
    _, tcam, _ = convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        {f: getattr(meta, f) for f in meta.__dataclass_fields__},
        device="cpu")
    return cam, tcam


@pytest.mark.parametrize("focus_angle", [0.0, 0.05])
def test_torch_camera_lanes(focus_angle):
    jcam, tcam = _camera_pair(focus_angle)
    jcfg, tcfg = _cfgs(4, 2, 3, "stratified")
    rs = np.random.default_rng(1)
    px = rs.integers(0, 48, 1024)
    py = rs.integers(0, 32, 1024)
    si = rs.integers(0, 8, 1024)
    jo = jc.camera_lanes(jcam, jcfg, jnp.asarray(px), jnp.asarray(py),
                         jnp.asarray(si, jnp.uint32))
    to = tc.camera_lanes(tcam, tcfg, _t(px), _t(py), _t(si))
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_torch_new_film_defaults_to_the_card(monkeypatch):
    """new_film without a device runs on the GPU, and raises without one
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.new_film((4, 2))
    film = tf.new_film((4, 2), device="cpu")
    assert film["rgb"].shape == (8, 3) and film["weight"].device.type == "cpu"


def test_torch_film_splats():
    rs = np.random.default_rng(2)
    w, h, rows = 40, 24, 8
    n = w * rows
    pix = np.arange(n)
    p = (np.stack([pix % w, pix // w], -1)
         + rs.random((n, 2))).astype(np.float32)
    col = rs.random((n, 3)).astype(np.float32)
    jfilm = jf.splat_rows(jf.new_film((w, h)), j_mitchell(), (w, h), 8, rows,
                          jnp.asarray(p), jnp.asarray(col))
    tfilm = tf.splat_rows(tf.new_film((w, h), device="cpu"), t_mitchell(),
                          (w, h), 8, rows, _t(p), _t(col))
    for k in ("rgb", "weight"):
        np.testing.assert_allclose(tfilm[k].numpy(), np.asarray(jfilm[k]),
                                   rtol=1e-5, atol=1e-6)
    # scatter splat, some taps off the image
    p2 = (rs.random((500, 2)) * [w + 4, h + 4] - 2).astype(np.float32)
    col2 = rs.random((500, 3)).astype(np.float32)
    jfilm = jf.splat(jfilm, j_mitchell(), (w, h), jnp.asarray(p2),
                     jnp.asarray(col2))
    tfilm = tf.splat(tfilm, t_mitchell(), (w, h), _t(p2), _t(col2))
    for k in ("rgb", "weight"):
        np.testing.assert_allclose(tfilm[k].numpy(), np.asarray(jfilm[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tf.to_uint8(tfilm, (w, h)), np.asarray(jf.to_uint8(jfilm, (w, h))))


# ---------------------------------------------------------------------------
# BSDFs
# ---------------------------------------------------------------------------

def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _bsdf_inputs(seed, n, mtype):
    rs = np.random.default_rng(seed)
    ns = _unit(rs, n)
    # geometric normal near the shading one; tangent orthogonal to ns
    ng = ns + 0.1 * _unit(rs, n)
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    tan = np.cross(ns, _unit(rs, n))
    tan = (tan / np.linalg.norm(tan, axis=-1, keepdims=True)).astype(
        np.float32)
    p = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    it = dict(p=p, p_raw=p, n=ng, ns=ns, tangent=tan)
    mat = dict(type=np.full(n, mtype, np.int32),
               base_color=rs.uniform(0.1, 1, (n, 3)).astype(np.float32),
               roughness=rs.choice([0.0, 0.05, 0.3, 0.8, 1.0],
                                   n).astype(np.float32),
               metallic=rs.uniform(0, 1, n).astype(np.float32),
               ior=rs.choice([1.0, 1.33, 1.5, 2.4], n).astype(np.float32))
    d = _unit(rs, n)
    wi = _unit(rs, n)
    u = rs.random(n).astype(np.float32)
    uv = rs.random((n, 2)).astype(np.float32)
    return it, mat, d, wi, u, uv


@pytest.mark.parametrize("mtype", [0, 1, 2, 3])
def test_torch_bsdf_matches_jax(mtype):
    it, mat, d, wi, u, uv = _bsdf_inputs(10 + mtype, 4096, mtype)
    jit = {k: jnp.asarray(v) for k, v in it.items()}
    tit = {k: _t(v) for k, v in it.items()}
    jmat = {k: jnp.asarray(v) for k, v in mat.items()}
    tmat = {k: _t(v) for k, v in mat.items()}
    js = jb.bsdf_sample(jmat, jnp.asarray(d), jit, jnp.asarray(u),
                        jnp.asarray(uv))
    ts = tb.bsdf_sample(tmat, _t(d), tit, _t(u), _t(uv))
    names = ("wi", "f", "pdf", "flags", "valid", "origin")
    for name, a, b in zip(names, js, ts):
        a = np.asarray(a)
        b = b.numpy().astype(a.dtype)
        if a.dtype == bool or name == "flags":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    jf_, jp_ = jb.bsdf_eval_pdf(jmat, jnp.asarray(d), jit, jnp.asarray(wi))
    tf_, tp_ = tb.bsdf_eval_pdf(tmat, _t(d), tit, _t(wi))
    np.testing.assert_allclose(tf_.numpy(), np.asarray(jf_), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------

def _light_scene(sampler):
    b = JBuilder()
    m = b.add_diffuse()
    b.add_quad([-1, 3, -1], [2, 0, 0], [0, 0, 2], material=m,
               emission=(4, 3, 2), one_sided=True)
    b.add_sphere([2, 2, 1], 0.5, material=m, emission=(1, 2, 3))
    rs = np.random.default_rng(4)
    verts = rs.uniform(-2, 2, (6, 3)).astype(np.float32) + [0, 4, 0]
    b.add_mesh(verts, np.asarray([[0, 1, 2], [3, 4, 5]]), material=m,
               emission=(2, 2, 2))
    b.add_uniform_inf_light((0.3, 0.4, 0.5))
    b.add_distant_light((-0.3, -1.0, 0.2), (3, 3, 3))
    b.add_point_light((0.5, 5.0, -0.5), (10, 9, 8))
    b.add_quad([-8, 0, -8], [16, 0, 0], [0, 0, 16], material=m)
    b.light_sampler = sampler
    b.set_camera([0, 2, -8], [0, 1, 0], 0.8, (8, 8))
    scene, cam, meta = b.build(accel="brute")
    tscene, _, tmeta = convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        {f: getattr(meta, f) for f in meta.__dataclass_fields__},
        device="cpu")
    return scene, meta, tscene, tmeta


@pytest.mark.parametrize("sampler", ["power", "uniform"])
def test_torch_lights_match_jax(sampler):
    scene, meta, tscene, tmeta = _light_scene(sampler)
    assert meta.n_lights == tmeta.n_lights >= 6
    rs = np.random.default_rng(5)
    n = 2048
    u = rs.random(n).astype(np.float32)
    uv = rs.random((n, 2)).astype(np.float32)
    ref_p = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ji, jpmf, jv = jl.sample_light_index(scene, meta, jnp.asarray(u))
    ti, tpmf, tv = tl.sample_light_index(tscene, tmeta, _t(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tpmf.numpy(), np.asarray(jpmf), rtol=1e-6)
    # every light kind, not only the sampled ones
    idx = np.arange(n) % meta.n_lights
    np.testing.assert_allclose(
        tl.light_pmf(tscene, tmeta, _t(idx)).numpy(),
        np.asarray(jl.light_pmf(scene, meta, jnp.asarray(idx))), rtol=1e-6)
    js = jl.light_sample(scene, meta, jnp.asarray(idx), jnp.asarray(ref_p),
                         jnp.asarray(u), jnp.asarray(uv), None)
    ts = tl.light_sample(tscene, tmeta, _t(idx), _t(ref_p), _t(u), _t(uv))
    for k in ("is_delta", "to_inf", "dir", "dist", "p", "n", "uv",
              "L_delta"):
        a, b = np.asarray(js[k]), ts[k].numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    jpdf = jl.light_sample_pdf(scene, meta, jnp.asarray(idx), js,
                               jnp.asarray(ref_p), js["dir"])
    tpdf = tl.light_sample_pdf(tscene, tmeta, _t(idx), ts, _t(ref_p),
                               ts["dir"])
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4,
                               atol=1e-6)
    jL = jl.light_sample_L(scene, meta, jnp.asarray(idx), js, js["dir"])
    tL = tl.light_sample_L(tscene, tmeta, _t(idx), ts, ts["dir"])
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=1e-6)
