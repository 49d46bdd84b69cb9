"""The beam backend of pathtracing_tpu_torch (accel/beam.py, the block cut
of accel/build.py::build_beam) against the JAX package's accel/beam.py and
build_bvh: the tables, closest and any-hit traversal on the same
numpy-seeded rays, the builder's accel choice (accel="auto" on a
triangle-free scene of 4,096 prims or more, and the motion / instance
fallbacks), and a small render through accel="beam" in both packages."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.accel import beam as jbeam
from pathtracing_tpu.accel.build import build_bvh as j_build_bvh
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch.accel import beam as tbeam
from pathtracing_tpu_torch.accel.build import build_beam
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)

BEAM_KEYS = ("blk_lo", "blk_hi", "blk_base", "blk_k", "prim_kind",
             "prim_idx", "beam_tri", "beam_sph", "beam_quad")


def _host_arrays(kind, seed=0):
    """Prims of one or every kind, at their real lengths."""
    rng = np.random.default_rng(seed)
    out = {}
    if kind in ("triangles", "mixed"):
        v0 = rng.uniform(-6, 6, (900, 3)).astype(np.float32)
        out["tri_v"] = np.stack(
            [v0, v0 + rng.normal(0, .5, (900, 3)).astype(np.float32),
             v0 + rng.normal(0, .5, (900, 3)).astype(np.float32)], 1)
    if kind in ("spheres", "mixed"):
        out["sph_c"] = rng.uniform(-6, 6, (700, 3)).astype(np.float32)
        out["sph_r"] = rng.uniform(0.05, 0.4, 700).astype(np.float32)
    if kind in ("quads", "mixed"):
        out["quad_q"] = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
        out["quad_u"] = rng.normal(0, .5, (500, 3)).astype(np.float32)
        out["quad_v"] = rng.normal(0, .5, (500, 3)).astype(np.float32)
    return out


def _rays(seed, n, spread=6.0):
    """Rays from a shell toward the prims' box; every third bounded."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * (2.0 * spread)
    d = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) - o
    d[::13, 1] = 0.0                         # axis-parallel components
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full((n,), 3e38, np.float32)
    t_max[::3] = 2.2 * spread
    return o.astype(np.float32), d, t_max


@pytest.mark.parametrize("kind", ["spheres", "quads", "triangles", "mixed"])
def test_torch_beam_tables_match_jax(kind):
    """build_beam's block cut and prim tables equal the JAX build_bvh's
    (same SAH order, the same padding, the same quad plane data)."""
    host = _host_arrays(kind)
    ja, jmeta = j_build_bvh(dict(host))
    ta, k = build_beam(dict(host))
    assert k == jmeta.block_k
    assert set(ta) == set(BEAM_KEYS)
    for key in BEAM_KEYS:
        np.testing.assert_array_equal(ta[key], np.asarray(ja[key]),
                                      err_msg=key)
    assert ta["blk_lo"].shape[0] > 8


@pytest.mark.parametrize("any_hit", [False, True])
def test_torch_beam_intersect_matches_jax(any_hit):
    """beam_intersect (closest and any-hit) over triangles, spheres and
    quads equals the JAX beam_intersect on the same rays: valid, kind and
    idx exactly, t to rtol=1e-5 (the ray chunks of the port are many
    here, so the chunked walk is exercised)."""
    host = _host_arrays("mixed", seed=1)
    ja, jmeta = j_build_bvh(dict(host))
    ta, k = build_beam(dict(host))
    o, d, t_max = _rays(2, 1500)
    want = jbeam.beam_intersect({kk: jnp.asarray(ja[kk]) for kk in
                                 BEAM_KEYS}, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), jmeta.block_k,
                                any_hit=any_hit)
    tabs = {kk: torch.from_numpy(np.ascontiguousarray(v))
            for kk, v in ta.items()}
    got = tbeam.beam_intersect(tabs, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t_max), k, any_hit=any_hit)
    valid = np.asarray(want["valid"])
    assert 300 < valid.sum() < len(valid)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    kinds = np.asarray(want["kind"])[valid]
    assert set(kinds.tolist()) == {0, 1, 2}
    # any-hit: whichever occluder the walk met first, the same one in both
    np.testing.assert_array_equal(got["kind"].numpy()[valid], kinds)
    np.testing.assert_array_equal(got["idx"].numpy()[valid],
                                  np.asarray(want["idx"])[valid])
    np.testing.assert_allclose(got["t"].numpy()[valid],
                               np.asarray(want["t"])[valid], rtol=1e-5)


def _spheres(B, n_side=65, **build_kw):
    """A triangle-free grid of n_side^2 small spheres (4,225 >= 4,096)
    over a ground quad."""
    b = B()
    mat = b.add_diffuse((0.6, 0.5, 0.4))
    xs = np.linspace(-8, 8, n_side)
    for x in xs:
        for z in xs:
            b.add_sphere([float(x), 0.1, float(z)], 0.09, material=mat)
    b.add_quad([-9, 0, -9], [18, 0, 0], [0, 0, 18], material=mat)
    b.add_uniform_inf_light((0.6, 0.7, 0.9))
    b.set_camera([0, 6, -12], [0, 0, 0], math.radians(40), (8, 8))
    return b.build(**build_kw)


def test_torch_auto_picks_beam_like_jax():
    """A triangle-free scene of 4,096 prims or more takes the beam backend
    in both packages, with the same tables; `intersect` through it equals
    the brute scan of the same scene."""
    js, _, jm = _spheres(JBuilder)
    ts, _, tm = _spheres(TBuilder, device="cpu")
    assert jm.accel == "beam" and tm.accel == "beam"
    assert tm.block_k == jm.block_k and tm.n_sph == 65 * 65
    for key in BEAM_KEYS:
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=key)
    rng = np.random.default_rng(4)
    o = torch.from_numpy(np.tile(np.float32([[0, 6, -12]]), (400, 1)))
    tgt = rng.uniform(-8, 8, (400, 3)).astype(np.float32)
    tgt[:, 1] = 0.05
    d = torch.nn.functional.normalize(torch.from_numpy(tgt) - o, dim=-1)
    got = tisect.intersect(ts, tm, o, d, 3e38, device="cpu")
    ref = tisect.intersect(ts, dataclasses.replace(tm, accel="brute"), o, d,
                           3e38, device="cpu")
    assert (got["kind"] == 1).sum() > 50 and (got["kind"] == 2).sum() > 50
    for key in ("valid", "kind", "idx"):
        assert torch.equal(got[key], ref[key]), key
    torch.testing.assert_close(got["t"], ref["t"], rtol=1e-5, atol=0.0)
    occ = tisect.occluded(ts, tm, o, d, torch.full((400,), 30.0),
                          device="cpu")
    assert torch.equal(occ, got["valid"] & (got["t"] < 30.0 - 1e-5))


def _fallback_scene(B, case):
    b = B()
    mat = b.add_diffuse((0.5, 0.5, 0.5))
    b.add_sphere([0, 0, 0], 1.0, material=mat)
    if case == "motion":
        b.add_sphere([3, 0, 0], 1.0, material=mat, velocity=(0.0, 1.0, 0.0))
    else:
        v = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
        f = np.int32([[0, 1, 2]])
        b.add_model_instance(b.add_model(v, f), runtime=True)
    b.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4), shutter=(0.0, 1.0))
    return b


@pytest.mark.parametrize("case", ["motion", "instance"])
def test_torch_beam_fallbacks_warn_like_jax(case):
    """accel="beam" on a moving or a run-time-instanced scene warns and
    builds the brute scan, as the JAX builder does; accel="bvh" stays
    refused."""
    with pytest.warns(UserWarning, match="falling back to accel='brute'"):
        _, _, jm = _fallback_scene(JBuilder, case).build(accel="beam")
    b = _fallback_scene(TBuilder, case)
    with pytest.warns(UserWarning, match="falling back to accel='brute'"):
        ts, _, tm = b.build(accel="beam", device="cpu")
    assert jm.accel == tm.accel == "brute" and "blk_lo" not in ts
    assert (tm.has_motion, tm.n_inst) == (jm.has_motion, jm.n_inst)
    with pytest.raises(NotImplementedError):
        b.build(accel="bvh", device="cpu")


def _cornell(B, **build_kw):
    b = B()
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_diffuse((0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_diffuse((0.12, 0.45, 0.15), roughness=1.0)
    glass = b.add_dielectric(ior=1.5, roughness=0.0)
    metal = b.add_conductor((0.8, 0.85, 0.88))
    s = 555.0
    b.add_quad([s, 0, 0], [0, s, 0], [0, 0, s], material=green)
    b.add_quad([0, 0, 0], [0, s, 0], [0, 0, s], material=red)
    b.add_quad([0, 0, 0], [s, 0, 0], [0, 0, s], material=white)
    b.add_quad([0, s, 0], [s, 0, 0], [0, 0, s], material=white)
    b.add_quad([0, 0, s], [s, 0, 0], [0, s, 0], material=white)
    b.add_quad([213, s - 1.0, 227], [130, 0, 0], [0, 0, 105],
               material=white, emission=(15.0, 15.0, 15.0), one_sided=False)
    b.add_sphere([190, 90, 190], 90, material=glass)
    b.add_sphere([380, 90, 380], 90, material=metal)
    b.set_camera(look_from=[278, 278, -800], look_at=[278, 278, 0],
                 fov=math.radians(40.0) * 2, resolution=(24, 24))
    return b.build(accel="beam", **build_kw)


def test_torch_beam_cornell_render_matches_jax():
    """A small Cornell render through accel="beam", built by each package
    and carried across from the JAX one, meets the JAX beam render on more
    than 99% of pixel values (rtol=1e-4, atol=1e-5)."""
    js, jc, jm = _cornell(JBuilder)
    assert jm.accel == "beam"
    kw = dict(spp=4, max_depth=4, integrator="path")
    want = np.asarray(j_render(js, jc, jm, JConfig(
        sampler=JSampler(x_samples=2, y_samples=2, seed=5), **kw)))
    assert np.isfinite(want).all() and want.mean() > 0.01
    carried = convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in js.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in jc.items()},
        {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)},
        device="cpu")
    for scene, cam, meta in (_cornell(TBuilder, device="cpu"), carried):
        assert meta.accel == "beam" and meta.block_k == jm.block_k
        got = t_render(scene, cam, meta, TConfig(
            sampler=TSampler(x_samples=2, y_samples=2, seed=5), **kw),
            device="cpu").numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()
