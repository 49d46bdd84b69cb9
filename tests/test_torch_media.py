"""Participating media and the volumetric integrator of
pathtracing_tpu_torch (core/medium.py, core/phase.py, the builder's media
table, integrators/path.py::transmittance and integrator="volpath")
against the JAX package."""
import dataclasses
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.core import medium as jmedium
from pathtracing_tpu.core import phase as jphase
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators import path as jpath
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.core import medium as tmedium
from pathtracing_tpu_torch.core import phase as tphase
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators import path as tpath
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import builder as tbuilder

torch.set_num_threads(2)

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _seeded(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    sig_t = rng.uniform(0.01, 3.0, (n, 3)).astype(np.float32)
    sig_s = (sig_t * rng.uniform(0, 1, (n, 3))).astype(np.float32)
    t_max = rng.uniform(0, 5, n).astype(np.float32)
    t_max[::7] = 3e38
    u = rng.random((n, 4)).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[::5] = 0.0
    return sig_t, sig_s, t_max, u, w, g


def test_torch_medium_functions_match_jax():
    """medium_tr and medium_sample on seeded inputs: the sampling decisions
    exactly, distances and weights to float rounding (the packages' log /
    exp differ by an ulp)."""
    sig_t, sig_s, t_max, u, _, _ = _seeded()
    j = jmedium.medium_sample(*map(jnp.asarray, (sig_t, sig_s, t_max,
                                                 u[:, 0], u[:, 1])))
    t = tmedium.medium_sample(*map(torch.from_numpy, (sig_t, sig_s, t_max,
                                                      u[:, 0], u[:, 1])))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    assert 0 < t[0].sum() < len(t_max)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6)
    # (atol: weights that underflow to denormals in one package)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=2e-6,
                               atol=1e-30)
    tt = np.asarray(j[1])
    np.testing.assert_allclose(
        tmedium.medium_tr(torch.from_numpy(sig_t), torch.from_numpy(tt)),
        np.asarray(jmedium.medium_tr(jnp.asarray(sig_t), jnp.asarray(tt))),
        rtol=2e-6, atol=1e-30)


def test_torch_phase_functions_match_jax():
    """phase_hg, hg_pdf and hg_sample (isotropic and anisotropic lanes) on
    seeded inputs."""
    _, _, _, u, w, g = _seeded(seed=1)
    uv = u[:, 2:4]
    jw, jp = jphase.hg_sample(jnp.asarray(w), jnp.asarray(g), jnp.asarray(uv))
    tw, tp = tphase.hg_sample(torch.from_numpy(w), torch.from_numpy(g),
                              torch.from_numpy(uv))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    w2 = np.asarray(jw)
    np.testing.assert_allclose(
        tphase.hg_pdf(torch.from_numpy(w), torch.from_numpy(w2),
                      torch.from_numpy(g)).numpy(),
        np.asarray(jphase.hg_pdf(jnp.asarray(w), jnp.asarray(w2),
                                 jnp.asarray(g))), rtol=1e-5)
    c = np.linspace(-1, 1, 101, dtype=np.float32)
    gg = np.full_like(c, 0.7)
    np.testing.assert_allclose(
        tphase.phase_hg(torch.from_numpy(c), torch.from_numpy(gg)).numpy(),
        np.asarray(jphase.phase_hg(jnp.asarray(c), jnp.asarray(gg))),
        rtol=1e-6)


def test_torch_media_arrays_match_jax():
    """The builder's media table, the shapes' medium ids and the media
    fields of the meta, on spheres_medium."""
    js, _, jm = jscenes.spheres_medium(resolution=(8, 8))
    ts, _, tm = tscenes.spheres_medium(resolution=(8, 8), device="cpu")
    for k in ("med_sigma_a", "med_sigma_s", "med_sigma_t", "med_g", "med_le",
              "sph_prop", "quad_prop"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert (tm.n_media, tm.scene_medium, tm.camera_medium) == \
        (jm.n_media, jm.scene_medium, jm.camera_medium) == (2, 1, -1)
    # a camera medium and a meshed medium boundary reach the tables too
    built = []
    for b in (JBuilder(), tbuilder.SceneBuilder()):
        fog = b.add_medium((0.1, 0.1, 0.1), (0.2, 0.2, 0.2), g=0.4,
                           density=2.0, le=(1, 0, 0), le_density=0.5)
        v, f = tscenes.sphere_mesh((0, 0, 0), 1.0, 6, 8)
        b.add_mesh(v, f, medium=fog)
        b.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4), medium=fog)
        built.append(b.build() if isinstance(b, JBuilder)
                     else b.build(device="cpu"))
    (js, _, jm), (ts, _, tm) = built
    for k in ("med_sigma_a", "med_sigma_s", "med_g", "med_le", "tri_prop"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert (tm.n_media, tm.camera_medium) == (jm.n_media,
                                              jm.camera_medium) == (1, 0)


def _mesh_scene_pair(two_level, resolution=(16, 16)):
    """medium_mesh built by both packages from the same calls (the JAX
    package's builder gets the port's sphere mesh); two_level forces the
    traversal tables onto K1 in both."""
    v, f = tscenes.sphere_mesh((0.0, 2.0, 0.0), 2.0, 40, 64)
    b = JBuilder()
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.4, 0.3, 0.2),
                       g=0.3)
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    b.add_quad([-20, 0, -20], [40, 0, 0], [0, 0, 40], material=white)
    b.add_mesh(v, f, medium=fog)
    b.add_sphere([-4, 1, 1], 1.0, material=white)
    b.add_quad([-2, 8, -2], [4, 0, 0], [0, 0, 4], material=white,
               emission=(15, 15, 15))
    b.add_uniform_inf_light((0.1, 0.1, 0.12))
    b.set_camera(look_from=[0, 3, -10], look_at=[0, 2, 0],
                 fov=math.radians(40.0), resolution=resolution)
    mp = pytest.MonkeyPatch()
    if two_level:
        mp.setenv("PT_TWOLEVEL_MIN", "0")
        mp.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    try:
        js = b.build()
        ts = tscenes.medium_mesh(resolution=resolution, device="cpu")
    finally:
        mp.undo()
    assert js[2].accel == ts[2].accel == "pallas"
    assert ("pk_l1_base" in js[0]) == ("pk_l1_base" in ts[0]) == two_level
    return js, ts


def _march_rays(n=192, seed=4):
    """Shadow-ray-like segments from inside, outside and across the fog
    sphere toward the light and the sky."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4, 0.2, -4], [4, 4.5, 4], (n, 3)).astype(np.float32)
    target = rng.uniform([-2, 8, -2], [2, 8, 2], (n, 3)).astype(np.float32)
    d = target - o
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    d = (d / dist[:, None]).astype(np.float32)
    dist[::4] = 3e38                       # to the sky
    inside = np.linalg.norm(o - [0, 2, 0], axis=1) < 2.0
    medium = np.where(inside, 0, -1).astype(np.int32)
    active = np.ones(n, bool)
    active[::9] = False
    return o, d, dist, medium, active


@pytest.mark.parametrize("tables", ["brute", "single_level", "two_level"])
def test_torch_transmittance_matches_jax(tables):
    """transmittance through a medium bounded by a 4,992-triangle mesh:
    on brute tables and on the traversal tables (single- and two-level,
    plain versions here, the Pallas kernels in interpret mode there), the
    blocked flags exactly and Tr to rtol 1e-5."""
    js, ts = _mesh_scene_pair(tables == "two_level")
    if tables == "brute":
        js = (js[0], js[1], dataclasses.replace(js[2], accel="brute"))
        ts = (ts[0], ts[1], dataclasses.replace(ts[2], accel="brute"))
    o, d, dist, medium, active = _march_rays()
    jtr, jbl = jpath.transmittance(js[0], js[2], *map(
        jnp.asarray, (o, d, dist, medium, active)))
    ttr, tbl = tpath.transmittance(ts[0], ts[2], *map(
        torch.from_numpy, (o, d, dist, medium.astype(np.int64), active)))
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jbl))
    assert 0 < tbl.sum() < active.sum()
    jtr = np.asarray(jtr)
    assert (jtr < 0.99).any()              # some rays crossed the fog
    np.testing.assert_allclose(ttr.numpy(), jtr, rtol=1e-5, atol=1e-7)


def test_torch_medium_scene_carries_across():
    """from_numpy_scene on spheres_medium: the media table and fields come
    across and the carried scene renders the port's own image."""
    js, jc, jm = jscenes.spheres_medium(resolution=(12, 12))
    scene, cam, meta = convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in js.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in jc.items()},
        {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)},
        device="cpu")
    own = tscenes.spheres_medium(resolution=(12, 12), device="cpu")
    assert (meta.n_media, meta.scene_medium) == (2, 1)
    for k in ("med_sigma_a", "med_sigma_s", "med_sigma_t", "med_g",
              "med_le"):
        assert torch.equal(scene[k], own[0][k]), k
    cfg = TConfig(spp=2, max_depth=3, integrator="volpath",
                  sampler=TSampler(x_samples=2, y_samples=1, seed=2))
    a = t_render(scene, cam, meta, cfg, device="cpu")
    b = t_render(*own, cfg, device="cpu")
    assert torch.equal(a, b)


def test_torch_medium_golden():
    """The JAX package's committed `medium` golden (spheres_medium 24x24,
    volpath, spp 4, depth 4), at the port's golden tolerance (rtol=2e-4,
    atol=2e-5)."""
    scene, cam, meta = tscenes.spheres_medium(resolution=(24, 24),
                                              device="cpu")
    cfg = TConfig(spp=4, max_depth=4, integrator="volpath",
                  sampler=TSampler(x_samples=2, y_samples=2, seed=11))
    got = t_render(scene, cam, meta, cfg, device="cpu").numpy()
    want = np.load(GOLDEN_DIR / "medium.npy")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_volpath_render_matches_jax(regenerate):
    """spheres_medium at 24x24 with integrator="volpath", sample for
    sample against the JAX package: > 99% of values within rtol=1e-4,
    atol=1e-5 at max_depth=6 (medium scatter vertices, phase sampling,
    transmittance-marched shadow rays, the glass sphere's medium
    handoff)."""
    kw = dict(spp=4, max_depth=6, integrator="volpath", regenerate=regenerate)
    jcfg = JConfig(sampler=JSampler(x_samples=2, y_samples=2, seed=9), **kw)
    tcfg = TConfig(sampler=TSampler(x_samples=2, y_samples=2, seed=9), **kw)
    want = np.asarray(j_render(*jscenes.spheres_medium(resolution=(24, 24)),
                               jcfg))
    got = t_render(*tscenes.spheres_medium(resolution=(24, 24),
                                           device="cpu"), tcfg,
                   device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0.005
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, close.mean()


def test_torch_volpath_mesh_render_matches_jax():
    """A medium bounded by a 4,992-triangle mesh (the traversal tables'
    plain versions here, the Pallas kernels in interpret mode there), 8x8,
    volpath, depth 4: > 99% of values within rtol=1e-4, atol=1e-5."""
    js, ts = _mesh_scene_pair(False, resolution=(8, 8))
    kw = dict(spp=2, max_depth=4, integrator="volpath")
    want = np.asarray(j_render(*js, JConfig(
        sampler=JSampler(x_samples=2, y_samples=1, seed=3), **kw)))
    got = t_render(*ts, TConfig(sampler=TSampler(x_samples=2, y_samples=1,
                                                 seed=3), **kw),
                   device="cpu").numpy()
    assert got.mean() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, close.mean()


def test_torch_volpath_reduces_to_path_without_media():
    """With no media in the scene, volpath agrees with path (the JAX
    package's test_volpath_reduces_to_path_without_media)."""
    scene, cam, meta = tscenes.cornell_box(resolution=(16, 16), device="cpu")
    kw = dict(spp=16, max_depth=4,
              sampler=TSampler(x_samples=4, y_samples=4, seed=5))
    img_p = t_render(scene, cam, meta, TConfig(integrator="path", **kw),
                     device="cpu").numpy()
    img_v = t_render(scene, cam, meta, TConfig(integrator="volpath", **kw),
                     device="cpu").numpy()
    np.testing.assert_allclose(img_v, img_p, rtol=1e-4, atol=1e-5)
