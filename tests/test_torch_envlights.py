"""Environment-map, function and emissive-texture lights of
pathtracing_tpu_torch against the JAX package: the importance tables and
light tables bit-equal, env_pdf / env_sample_dir / infinite_le on the same
inputs, renders by the 99% rule (the light-consistency tests of
tests/test_lights.py are mirrored in test_torch_lights.py)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene import lights as jlights
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import lights as tlights
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder

torch.set_num_threads(2)

_TABLE_KEYS = ("env_weights", "env_cdf", "env_total", "light_env_slot",
               "light_emtex", "light_type", "light_color", "light_shape",
               "light_area", "light_power", "light_cdf", "inf_idx",
               "tex_texels", "tex_info_i", "tex_info_f", "tri_prop",
               "quad_prop")
_META_KEYS = ("n_env", "env_nx", "env_ny", "has_emissive_tex", "n_inf",
              "n_lights")


def _base(B, res=(24, 24)):
    """tests/test_lights.py's scene: a floor and a sphere."""
    b = B()
    m = b.add_diffuse((0.6, 0.55, 0.5), roughness=1.0)
    b.add_quad([-4, 0, -4], [8, 0, 0], [0, 0, 8], material=m)
    b.add_sphere([0, 1, 0], 1.0, material=m)
    b.set_camera([0, 2.5, -6], [0, 1, 0], math.radians(40), res)
    return b


def _sky(seed, hot):
    rng = np.random.default_rng(seed)
    sky = (0.2 + rng.uniform(0, 1, (16, 32, 3)) ** 2).astype(np.float32)
    (y0, y1), (x0, x1) = hot
    sky[y0:y1, x0:x1] *= 20.0     # a hot patch for the importance table
    return sky


def _fn_sky(d):
    return np.stack([1.0 + d[:, 1], 0.5 + 0.5 * d[:, 0] ** 2,
                     np.full(len(d), 0.8)], -1).astype(np.float32)


def _lit(B, res=(24, 24)):
    """Two env lights (a texture, a function), a checker-textured emissive
    quad and a checker-textured emissive mesh strip of small triangles
    (below the power cull: kept by the textured emitter's 1e-6 floor)."""
    b = _base(B, res)
    b.add_env_light(b.textures.add_image(_sky(0, ((4, 8), (10, 14)))),
                    scale=0.8)
    b.add_function_inf_light(_fn_sky, nx=64, ny=32)
    a = b.textures.add_solid((3.0, 1.0, 0.5))
    c = b.textures.add_solid((0.5, 2.0, 4.0))
    ck = b.textures.add_checker(a, c, uv_scale=(0.25, 0.25))
    m = b.add_diffuse((0.5, 0.5, 0.5))
    b.add_quad([-1, 3, -1], [2, 0, 0], [0, 0, 2], material=m,
               emission=(1, 1, 1), em_tex=ck)
    xs = np.linspace(-3.0, 3.0, 13, dtype=np.float32)
    v = np.stack([np.repeat(xs, 2), np.tile([0.01, 0.03], 13),
                  np.full(26, 3.0, np.float32)], -1)
    f = np.asarray([[2 * i, 2 * i + 1, 2 * i + 2] for i in range(12)],
                   np.int32)
    b.add_mesh(v, f, material=m, em_tex=ck)
    return b


def _carry(scene, cam, meta):
    return convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        dataclasses.asdict(meta), device="cpu")


@pytest.fixture(scope="module")
def lit_scenes():
    return (_lit(JBuilder, (16, 16)).build(),
            _lit(TBuilder, (16, 16)).build(device="cpu"))


def test_torch_env_tables_bit_equal(lit_scenes):
    """Per-env-light importance tables, light tables and powers (the env
    lights' from their tables' mean luminance, the textured emitters'
    with the 1e-6 floor) equal the JAX builder's bit for bit."""
    (js, _, jm), (ts, _, tm) = lit_scenes
    assert tm.n_env == 2 and (tm.env_nx, tm.env_ny) == (1024, 512)
    assert tm.n_lights == 2 + 1 + 12 and tm.has_emissive_tex
    for k in _META_KEYS:
        assert getattr(tm, k) == getattr(jm, k), k
    for k in _TABLE_KEYS:
        want = np.asarray(js[k])
        got = ts[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_torch_env_sampling_matches_jax(lit_scenes):
    """env_pdf, env_sample_dir and infinite_le on the same inputs: the
    sampled cells exactly (directions drawn at cell centres and mapped
    back by each package's _env_cell_of), the rest to rtol=1e-5."""
    (js, _, jm), (ts, _, tm) = lit_scenes
    rng = np.random.default_rng(4)
    n = 4096
    env_ids = np.nonzero(np.asarray(js["light_type"]) == 1)[0]
    lid = rng.choice(env_ids, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    centre = np.full((n, 2), 0.5, np.float32)
    uv2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    T = torch.from_numpy

    jd = np.asarray(jlights.env_sample_dir(js, jm, jnp.asarray(lid),
                                           jnp.asarray(u),
                                           jnp.asarray(centre)))
    td = tlights.env_sample_dir(ts, tm, T(lid).long(), T(u), T(centre))
    jcell = np.asarray(jlights._env_cell_of(jm, jnp.asarray(jd)))
    tcell = tlights._env_cell_of(tm, td).numpy()
    np.testing.assert_array_equal(tcell, jcell)
    assert len(np.unique(jcell)) > 100
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)

    jd = np.asarray(jlights.env_sample_dir(js, jm, jnp.asarray(lid),
                                           jnp.asarray(u), jnp.asarray(uv2)))
    td = tlights.env_sample_dir(ts, tm, T(lid).long(), T(u), T(uv2))
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)
    for dirs in (d, jd):
        jp = np.asarray(jlights.env_pdf(js, jm, jnp.asarray(lid),
                                        jnp.asarray(dirs)))
        tp = tlights.env_pdf(ts, tm, T(lid).long(), T(dirs)).numpy()
        assert (jp > 0).all()
        np.testing.assert_allclose(tp, jp, rtol=1e-5)
        jl = np.asarray(jlights.infinite_le(js, jm, jnp.asarray(lid),
                                            jnp.asarray(dirs)))
        tl = tlights.infinite_le(ts, tm, T(lid).long(), T(dirs)).numpy()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    jm_pdf = np.asarray(jlights.infinite_light_mis_pdf(
        js, jm, jnp.asarray(lid), jnp.asarray(d)))
    tm_pdf = tlights.infinite_light_mis_pdf(ts, tm, T(lid).long(),
                                            T(d)).numpy()
    np.testing.assert_allclose(tm_pdf, jm_pdf, rtol=1e-5)


def test_torch_env_lit_render_matches_jax(lit_scenes):
    """Renders lit by the env map, the function light and the textured
    emitters, the port's own build and the JAX scene carried across,
    against the JAX image: > 99% of values within rtol=1e-4, atol=1e-5."""
    (js, jc, jm), own = lit_scenes
    kw = dict(spp=2, max_depth=4, integrator="path")
    want = np.asarray(j_render(js, jc, jm, JConfig(
        sampler=JSampler(x_samples=2, y_samples=1, seed=3), **kw)))
    # the port's regenerating drain gives each sample the wave loop's value
    kw["regenerate"] = True
    assert np.isfinite(want).all() and want.mean() > 0.05
    tcfg = TConfig(sampler=TSampler(x_samples=2, y_samples=1, seed=3), **kw)
    for scene, cam, meta in (own, _carry(js, jc, jm)):
        got = t_render(scene, cam, meta, tcfg, device="cpu").numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()


def test_torch_image_emissive_texture(monkeypatch):
    """An emitter textured with an image: its power uses the image's mean
    texel luminance (the JAX builder fails on images of more than one
    texel, so this is held to the texture's own numbers) and its
    radiance is the texture at the hit's uv."""
    b = _base(TBuilder, (16, 16))
    img = np.random.default_rng(2).uniform(0, 2, (8, 8, 3)).astype(
        np.float32)
    tid = b.textures.add_image(img)
    b.add_quad([-1, 3, -1], [2, 0, 0], [0, 0, 2], emission=(1, 1, 1),
               em_tex=tid)
    scene, cam, meta = b.build(device="cpu")
    mean_lum = float((img.reshape(-1, 3) @ np.asarray(
        [0.2126, 0.7152, 0.0722])).mean())
    assert meta.has_emissive_tex and meta.n_lights == 1
    assert float(scene["light_power"][0]) == pytest.approx(
        2.0 * 4.0 * mean_lum, rel=1e-6)
    uv = torch.tensor([[0.3, 0.7], [0.9, 0.1]])
    le = tlights.area_light_L(scene, meta, torch.zeros(2, dtype=torch.long),
                              torch.tensor([[0.0, -1.0, 0.0]] * 2), uv,
                              torch.tensor([[0.0, 1.0, 0.0]] * 2))
    from pathtracing_tpu_torch.scene.textures import texture_eval
    np.testing.assert_array_equal(
        le.numpy(), texture_eval(scene, torch.full((2,), tid), uv).numpy())
    img_out = t_render(scene, cam, meta, TConfig(spp=2, max_depth=3),
                       device="cpu")
    assert torch.isfinite(img_out).all() and float(img_out.mean()) > 0


def test_torch_textured_emissive_model_instances():
    """A model with an emission texture, instanced at run time and
    re-emitted as world triangles: per-triangle lights carry the texture
    in both, with the JAX builder's light tables."""
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    out = []
    for B in (JBuilder, TBuilder):
        b = _base(B, (8, 8))
        ck = b.textures.add_checker(b.textures.add_solid((2, 1, 1)),
                                    b.textures.add_solid((1, 1, 3)))
        mid = b.add_model(v + [0, 3, 0], f, em_tex=ck)
        b.add_model_instance(mid, runtime=True)
        b.add_model_instance(mid, np.diag([1.0, 1.0, 2.0, 1.0]))
        out.append(b.build(**({} if B is JBuilder else dict(device="cpu"))))
    (js, _, jm), (ts, _, tm) = out
    assert tm.n_lights == jm.n_lights == 4 and tm.n_inst == 1
    for k in ("light_emtex", "light_shape", "light_power", "light_area",
              "ilight_map", "inst_slot_base", "tri_prop"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
