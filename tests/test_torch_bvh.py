"""The bvh backend of pathtracing_tpu_torch (accel/traverse.py, the wide
BVH of accel/build.py::build_bvh) against the JAX package's accel/build.py
and accel/traverse.py: the leaf codes, the wide-node arrays of the NumPy
and the native builds, closest and any-hit walks on tests/test_bvh.py's
random scenes, the builder's accel="bvh" route and a Cornell render
through it in both packages."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.accel import build as jbuild
from pathtracing_tpu.accel.traverse import bvh_intersect as j_bvh_intersect
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch.accel import build as tbuild
from pathtracing_tpu_torch.accel.traverse import bvh_intersect
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_bvh import _random_scene, _rays
from test_torch_beam import BEAM_KEYS, _host_arrays
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)

BVH_KEYS = ("bvh_lo", "bvh_hi", "bvh_child")
SCENE_KEYS = ("tri_v", "sph_c", "sph_r", "quad_q", "quad_u", "quad_v",
              "quad_n", "quad_d", "quad_w")
BIG = 3e38


def test_torch_bvh_leaf_code_roundtrip():
    """_leaf_code / decode_leaf round trip on ints, arrays and tensors,
    with the JAX package's codes."""
    for base in (0, 1, 1000, 10_000_000):
        for count in range(1, tbuild.LEAF_SHIFT):
            code = tbuild._leaf_code(base, count)
            assert code == jbuild._leaf_code(base, count) < 0
            for c in (code, np.asarray(code), torch.tensor(code)):
                b, n = tbuild.decode_leaf(c)
                assert (int(b), int(n)) == (base, count)
    with pytest.raises(AssertionError):
        tbuild._leaf_code(0, tbuild.LEAF_SHIFT)
    assert (tbuild.W, tbuild.LEAF_MAX, tbuild.LEAF_SHIFT, tbuild.MAX_STACK) \
        == (jbuild.W, jbuild.LEAF_MAX, jbuild.LEAF_SHIFT, jbuild.MAX_STACK)


def test_torch_bvh_collapse_wide_matches_jax():
    """The NumPy binary SAH build collapsed to W-wide nodes equals the JAX
    package's _collapse_wide on the same binary tree."""
    host = _host_arrays("mixed", seed=3)
    lo, hi, _, _ = tbuild._prim_bounds(host)
    nodes, order = tbuild._sah_build_binary(lo, hi)
    got = tbuild._collapse_wide(nodes, order)
    want = jbuild._collapse_wide(*jbuild._sah_build_binary(lo, hi))
    for g, w, name in zip(got, want, ("lo", "hi", "child", "depth")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].shape[0] > 50 and got[3] > 2
    # every leaf of the tree appears once, and empty slots are (+inf, -inf)
    child = got[2]
    leaves = child[child < 0]
    base, cnt = tbuild.decode_leaf(leaves)
    assert int(cnt.sum()) == len(order)
    empty = np.isinf(got[0]).all(-1)
    assert (got[0][empty] > 0).all() and (got[1][empty] < 0).all()


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("kind", ["triangles", "mixed"])
def test_torch_build_bvh_matches_jax(backend, kind):
    """build_bvh's wide-node arrays, prim tables, beam block cut and
    BVHMeta equal the JAX build_bvh's of the same backend."""
    host = _host_arrays(kind, seed=5)
    ja, jm = jbuild.build_bvh(dict(host), backend=backend)
    ta, tm = tbuild.build_bvh(dict(host), backend=backend)
    assert set(ta) == set(ja) == set(BVH_KEYS + BEAM_KEYS)
    for key in ja:
        np.testing.assert_array_equal(ta[key], np.asarray(ja[key]),
                                      err_msg=key)
        assert ta[key].dtype == np.asarray(ja[key]).dtype, key
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.n_nodes > 20 and tm.n_prims == sum(
        len(v) for k, v in host.items() if k in ("tri_v", "sph_c", "quad_q"))
    with pytest.raises(ValueError):
        tbuild.build_bvh({}, backend=backend)


def _port_scene(scene):
    """The geometry of a JAX random scene with the port's own build_bvh
    tables (asserted equal to the JAX scene's)."""
    host = {k: np.asarray(scene[k]) for k in ("tri_v", "sph_c", "sph_r",
                                              "quad_q", "quad_u", "quad_v")}
    ta, _ = tbuild.build_bvh(host)
    for key in BVH_KEYS + ("prim_kind", "prim_idx"):
        np.testing.assert_array_equal(ta[key], np.asarray(scene[key]),
                                      err_msg=key)
    out = {k: torch.from_numpy(np.array(scene[k])) for k in SCENE_KEYS}
    out.update({k: torch.from_numpy(v) for k, v in ta.items()})
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_bvh_intersect_matches_jax(seed):
    """Closest-hit bvh_intersect on tests/test_bvh.py's random scenes of
    triangles, spheres and quads equals the JAX walk on the same rays:
    valid, kind and idx exactly, t to rtol=1e-5; and the same rays aimed
    into the scene's box likewise (several times the hits)."""
    rng = np.random.default_rng(seed)
    scene, _, _ = _random_scene(rng)
    o, d = _rays(rng)
    aim = np.random.default_rng(seed + 10).uniform(-10, 10, (256, 3))
    da = (aim - np.asarray(o)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    ts = _port_scene(scene)
    for dirs in (np.asarray(d), da.astype(np.float32)):
        tm = np.full((256,), BIG, np.float32)
        want = {k: np.asarray(v) for k, v in j_bvh_intersect(
            scene, o, jnp.asarray(dirs), jnp.asarray(tm)).items()}
        stats = {}
        got = bvh_intersect(ts, _t(o), _t(dirs), _t(tm), stats=stats)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        np.testing.assert_array_equal(got["kind"].numpy()[v], want["kind"][v])
        np.testing.assert_array_equal(got["idx"].numpy()[v], want["idx"][v])
        np.testing.assert_allclose(got["t"].numpy()[v], want["t"][v],
                                   rtol=1e-5)
        assert (got["t"].numpy()[~v] == BIG).all() and stats["iterations"] > 3
    assert v.sum() > 40 and set(want["kind"][v].tolist()) == {0, 1, 2}


def test_torch_bvh_any_hit_and_t_max():
    """Any-hit agrees with closest-hit on `valid` (tests/test_bvh.py's
    any-hit test, and the JAX any-hit walk's flags); shortening t_max
    below each closest hit makes every ray miss."""
    rng = np.random.default_rng(7)
    scene, _, _ = _random_scene(rng)
    o, d = _rays(rng, n=128)
    ts = _port_scene(scene)
    tm = torch.full((128,), 8.0)
    any_hit = bvh_intersect(ts, _t(o), _t(d), tm, any_hit=True)
    closest = bvh_intersect(ts, _t(o), _t(d), tm)
    assert torch.equal(any_hit["valid"], closest["valid"])
    want = j_bvh_intersect(scene, o, d, jnp.full((128,), 8.0), any_hit=True)
    np.testing.assert_array_equal(any_hit["valid"].numpy(),
                                  np.asarray(want["valid"]))
    rng = np.random.default_rng(3)
    scene, _, _ = _random_scene(rng)
    o, d = _rays(rng, n=128)
    ts = _port_scene(scene)
    full = bvh_intersect(ts, _t(o), _t(d), torch.full((128,), BIG))
    v = full["valid"]
    assert v.sum() > 0
    short = bvh_intersect(ts, _t(o), _t(d),
                          torch.where(v, full["t"] * 0.99, 1e-3))
    assert not short["valid"][v].any()


def _cornell(B, **build_kw):
    b = B()
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_diffuse((0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_diffuse((0.12, 0.45, 0.15), roughness=1.0)
    glass = b.add_dielectric(ior=1.5, roughness=0.0)
    s = 555.0
    b.add_quad([s, 0, 0], [0, s, 0], [0, 0, s], material=green)
    b.add_quad([0, 0, 0], [0, s, 0], [0, 0, s], material=red)
    b.add_quad([0, 0, 0], [s, 0, 0], [0, 0, s], material=white)
    b.add_quad([0, s, 0], [s, 0, 0], [0, 0, s], material=white)
    b.add_quad([0, 0, s], [s, 0, 0], [0, s, 0], material=white)
    b.add_quad([213, s - 1.0, 227], [130, 0, 0], [0, 0, 105],
               material=white, emission=(15.0, 15.0, 15.0), one_sided=False)
    b.add_sphere([190, 90, 190], 90, material=glass)
    # a box of triangles, so every shape kind goes through the walk
    v = np.float32([[300, 0, 300], [450, 0, 300], [450, 0, 450],
                    [300, 0, 450], [300, 160, 300], [450, 160, 300],
                    [450, 160, 450], [300, 160, 450]])
    f = np.int32([[0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7],
                  [2, 7, 6], [3, 0, 4], [3, 4, 7], [4, 5, 6], [4, 6, 7]])
    b.add_mesh(v, f, material=white)
    b.set_camera(look_from=[278, 278, -800], look_at=[278, 278, 0],
                 fov=math.radians(40.0) * 2, resolution=(24, 24))
    return b.build(accel="bvh", **build_kw)


def test_torch_bvh_cornell_render_matches_jax():
    """A small Cornell render (quads, a sphere, a triangle box) through
    accel="bvh", built by each package and carried across from the JAX
    one, meets the JAX bvh render on more than 99% of pixel values
    (rtol=1e-4, atol=1e-5); the port's tables equal the JAX builder's."""
    js, jc, jm = _cornell(JBuilder)
    assert jm.accel == "bvh"
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
    built = _cornell(TBuilder, device="cpu")
    for key in BVH_KEYS + BEAM_KEYS:
        np.testing.assert_array_equal(built[0][key].numpy(),
                                      np.asarray(js[key]), err_msg=key)
    for scene, cam, meta in (built, carried):
        assert meta.accel == "bvh" and meta.block_k == jm.block_k
        got = t_render(scene, cam, meta, TConfig(
            sampler=TSampler(x_samples=2, y_samples=2, seed=5), **kw),
            device="cpu").numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()


def test_torch_bvh_routes_intersect_and_occluded():
    """On an accel="bvh" scene, `intersect` and `occluded` go through the
    walk and equal the brute scan of the same scene."""
    scene, _, meta = _cornell(TBuilder, device="cpu")
    rng = np.random.default_rng(4)
    o = torch.from_numpy(np.tile(np.float32([[278, 278, -800]]), (600, 1)))
    tgt = torch.from_numpy(rng.uniform(0, 555, (600, 3)).astype(np.float32))
    tgt[:, 2] = 555.0
    d = torch.nn.functional.normalize(tgt - o, dim=-1)
    got = tisect.intersect(scene, meta, o, d, BIG, device="cpu")
    ref = tisect.intersect(scene, dataclasses.replace(meta, accel="brute"),
                           o, d, BIG, device="cpu")
    assert set(got["kind"].tolist()) == {0, 1, 2}
    for key in ("valid", "kind", "idx"):
        assert torch.equal(got[key], ref[key]), key
    torch.testing.assert_close(got["t"], ref["t"], rtol=1e-5, atol=0.0)
    occ = tisect.occluded(scene, meta, o, d, torch.full((600,), 1000.0),
                          device="cpu")
    assert torch.equal(occ, got["valid"] & (got["t"] < 1000.0 - 1e-5))
