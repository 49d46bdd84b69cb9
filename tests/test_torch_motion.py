"""Motion blur in pathtracing_tpu_torch against the JAX package: the
two-level tables and traversal with velocities (pallas_tri_intersect2 in
interpret mode), the kernel source as host C++, ray times from the camera
through the integrator, lights sampled at the ray time, moving instances,
and renders (a moving sphere, a moving mesh on the single-level kernel,
zero shutter equals static)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.accel import pallas_trace2 as jt2
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene import intersect as jisect
from pathtracing_tpu.scene import lights as jlights
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch.accel import cubuild, trace2
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import (render as t_film,
                                                      render_image as t_render)
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene import lights as tlights

from test_torch_instancing import _PF, _PV, _carry, _tf
from test_torch_trace1 import (_J, _T, _grid_mesh, _rays, _same,
                               _same_as_jax, _soup, _t3)
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _moving_soup(seed, n_tri, n_rays):
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 1.0, (n_tri, 3)).astype(np.float32)
    time = rng.uniform(0, 1, n_rays).astype(np.float32)
    return _soup(seed, n_tri), vel, time


@pytest.mark.parametrize("g", [4, 16])
def test_torch_trace2_motion_tables_and_kernel_match_jax(g):
    """Two-level tables with velocities (shutter-expanded boxes, velocity
    columns) and the traversal at per-ray times against the JAX package:
    slot ids equal, boxes equal, valid / tri equal, t to rtol=1e-5; culled
    plain == brute plain exactly."""
    n = 384
    tri_v, vel, time = _moving_soup(61, 3000, n)
    kw = dict(tri_vel=vel, shutter=(0.0, 1.0))
    ta, k2 = trace2.build_tri_blocks2(tri_v, g=g, **kw)
    ja, jk2 = jt2.build_tri_blocks2(tri_v, g=g, **kw)
    assert k2 == jk2
    for k in ("pk_slot2tri", "pk_l1_base", "pk_blk_lo", "pk_blk_hi"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    m1, w = len(ja["pk_l1_base"]), g * jk2 + 128
    np.testing.assert_array_equal(
        ta["pk_tri"].T, ja["pk_tri"].reshape(16, m1, w)[:12, :, :g * jk2]
        .reshape(12, -1))
    with pytest.raises(ValueError):
        trace2.build_tri_blocks2(tri_v, tri_mask=np.zeros((3000, 7), np.int32),
                                 **kw)
    o, d, t_max = _rays(62, n)
    tabs, tt = _T(ta), torch.from_numpy(time)
    got = trace2.tri_intersect2(tabs, *_t3(o, d, t_max), time=tt)
    _same(got, trace2.tri_intersect2_plain(tabs, *_t3(o, d, t_max), time=tt,
                                           prune=False))
    static = trace2.tri_intersect2(tabs, *_t3(o, d, t_max),
                                   time=torch.zeros(n))
    assert int((got["tri"] != static["tri"]).sum()) > 30   # it does move
    want = jt2.pallas_tri_intersect2(_J(ja), jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), k2, g=g,
                                     time=jnp.asarray(time))
    _same_as_jax(got, want)


def test_torch_trace2_motion_kernel_source_matches_plain(tmp_path):
    """The CUDA kernel's motion mode compiled as host C++ equals the plain
    version: the same keys, bit-equal t, 0 flips."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    lib = trace2.bind(cubuild.host_library("trace2", tmp_path))
    n = 500
    tri_v, vel, time = _moving_soup(63, 20000, n)
    ta, _ = trace2.build_tri_blocks2(tri_v, g=8, tri_vel=vel,
                                     shutter=(0.0, 1.0))
    o, d, t_max = _rays(64, n)
    tabs, tt = _T(ta), torch.from_numpy(time)
    pt, pk = trace2._plain_slots(tabs, *_t3(o, d, t_max), time=tt)
    ht, hk, _ = trace2._launch_kernel(tabs, *_t3(o, d, t_max), False, False,
                                      0, time=tt, host_lib=lib)
    assert (pk >= 0).sum() > 100
    assert torch.equal(hk, pk) and torch.equal(ht, pt)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def _moving_sphere(B, velocity, shutter, **kw):
    b = B()
    m = b.add_diffuse((0.9, 0.2, 0.2))
    b.add_sphere([0, 0, 0], 0.8, material=m, velocity=velocity)
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera([0, 0, -5], [0, 0, 0], math.radians(40), (32, 32),
                 shutter=shutter)
    return b.build(**kw)


def _cfgs(**kw):
    return (JConfig(sampler=JSampler(x_samples=2, y_samples=2), **kw),
            TConfig(sampler=TSampler(x_samples=2, y_samples=2), **kw))


def _frac_close(a, b, rtol=1e-4, atol=1e-5):
    return float(np.isclose(np.asarray(a), np.asarray(b), rtol=rtol,
                            atol=atol).mean())


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_moving_sphere_render_matches_jax(regenerate):
    """The ray time leaves the camera, rides the bounce loop (and the
    persistent wavefront's refills) and moves the sphere: > 99% of values
    within rtol=1e-4, atol=1e-5 of the JAX render, depth 3."""
    jcfg, tcfg = _cfgs(spp=4, max_depth=3, regenerate=regenerate,
                       rays_per_batch=256)
    want = np.asarray(j_render(*_moving_sphere(JBuilder, (2.5, 0, 0),
                                               (0.0, 1.0)), jcfg))
    got = t_render(*_moving_sphere(tbuilder.SceneBuilder, (2.5, 0, 0),
                                   (0.0, 1.0), device="cpu"), tcfg,
                   device="cpu").numpy()
    assert _frac_close(got, want) > 0.99
    still = t_render(*_moving_sphere(tbuilder.SceneBuilder, (0, 0, 0),
                                     (0.0, 1.0), device="cpu"), tcfg,
                     device="cpu").numpy()
    # the blurred sphere covers more pixels than the still one
    assert (got.mean(-1) > 0.99).mean() < (still.mean(-1) > 0.99).mean()


def test_torch_zero_shutter_equals_static():
    _, tcfg = _cfgs(spp=4, max_depth=2)
    a = t_render(*_moving_sphere(tbuilder.SceneBuilder, (0, 0, 0), (0.0, 0.0),
                                 device="cpu"), tcfg, device="cpu")
    b = t_render(*_moving_sphere(tbuilder.SceneBuilder, (2.5, 0, 0),
                                 (0.0, 0.0), device="cpu"), tcfg,
                 device="cpu")
    assert torch.equal(a, b)


def _moving_mesh(B, accel, **kw):
    v, f = _grid_mesh(52)                       # 5,202 triangles
    b = B()
    b.add_mesh(v, f, material=b.add_diffuse((0.7, 0.5, 0.3)),
               velocity=(1.5, 0.0, 0.0))
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera([0, 4, -7], [0, 0, 0], math.radians(40), (24, 24),
                 shutter=(0.0, 1.0))
    return b.build(accel=accel, **kw)


def test_torch_moving_mesh_single_level_kernel_matches_jax_and_brute():
    """A moving 5,202-triangle mesh keeps the traversal path, on the
    single-level tables (velocity columns, shutter-expanded boxes): the
    render agrees with the JAX render and with the port's brute build on
    > 99% of values (rtol=1e-4, atol=1e-5, depth 2)."""
    ts, tc, tm = _moving_mesh(tbuilder.SceneBuilder, "auto", device="cpu")
    assert tm.accel == "pallas" and tm.has_motion and "pk_l1_base" not in ts
    js, jc, jm = _moving_mesh(JBuilder, "auto")
    assert jm.accel == "pallas" and "pk_l1_base" not in js
    jcfg, tcfg = _cfgs(spp=4, max_depth=2)
    got = t_render(ts, tc, tm, tcfg, device="cpu").numpy()
    assert _frac_close(got, j_render(js, jc, jm, jcfg)) > 0.99
    brute = t_render(*_moving_mesh(tbuilder.SceneBuilder, "brute",
                                   device="cpu"), tcfg, device="cpu").numpy()
    assert _frac_close(got, brute) > 0.99


def test_torch_moving_mesh_two_level_kernel_matches_single(monkeypatch):
    """The same moving mesh forced onto the two-level tables returns the
    single-level tables' hits at the same ray times."""
    s1, _, m1 = _moving_mesh(tbuilder.SceneBuilder, "pallas", device="cpu")
    monkeypatch.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    s2, _, m2 = _moving_mesh(tbuilder.SceneBuilder, "pallas", device="cpu")
    assert "pk_l1_base" in s2 and "pk_l1_base" not in s1
    rng = np.random.default_rng(5)
    n = 512
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(1, 4, n),
                  rng.uniform(-4, 4, n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    h1 = tisect.intersect(s1, m1, torch.from_numpy(o), torch.from_numpy(d),
                          1e30, time=t, device="cpu")
    h2 = tisect.intersect(s2, m2, torch.from_numpy(o), torch.from_numpy(d),
                          1e30, time=t, device="cpu")
    assert int(h1["valid"].sum()) > 100
    for k in ("valid", "idx", "t"):
        assert torch.equal(h1[k], h2[k]), k


def _moving_instances(B, accel, **kw):
    b = B()
    mat = b.add_diffuse((0.7, 0.5, 0.3))
    pv = _PV * np.asarray([1, 1.25, 1], np.float32)
    mid = b.add_model(pv, _PF, material=mat)
    b.add_model_instance(mid, _tf(-2, 0, 0, ry=0.5), runtime=True,
                         velocity=(2.0, 0.5, 0.0))
    b.add_model_instance(mid, _tf(2, 0, 1, s=1.3), runtime=True)
    b.add_mesh(pv + np.asarray([0, 0, 4], np.float32), _PF, material=mat,
               velocity=(0.0, 1.0, 0.0))
    b.add_quad([-6, -0.2, -6], [12, 0, 0], [0, 0, 12],
               material=b.add_diffuse((0.5, 0.5, 0.5)))
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera([0, 4, -8], [0, 0.5, 0], math.radians(40), (24, 24),
                 shutter=(0.0, 1.0))
    return b.build(accel=accel, **kw)


def test_torch_moving_instance_matches_brute_and_jax():
    """A run-time instance with a world velocity beside moving world
    triangles: two-level instanced tables with motion; intersect at
    per-ray times equals the port's brute scan and the JAX package's
    (valid, kind, idx equal, t to rtol=1e-4, atol=1e-5); make_interaction
    puts the hit point on the moved geometry."""
    sp, _, mp = _moving_instances(tbuilder.SceneBuilder, "pallas",
                                  device="cpu")
    sb, _, mb = _moving_instances(tbuilder.SceneBuilder, "brute",
                                  device="cpu")
    js, _, jm = _moving_instances(JBuilder, "pallas")
    assert mp.has_motion and mp.n_inst == 2 and "pk_l1_base" in sp \
        and "pk_inst_velo" in sp
    rng = np.random.default_rng(11)
    n = 512
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(0.2, 4, n),
                  rng.uniform(-4, 4, n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 1.0, n).astype(np.float32)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t)
    hj = jisect.intersect(js, jm, jnp.asarray(o), jnp.asarray(d), 1e30,
                          time=jnp.asarray(t))
    m = np.asarray(hj["valid"])
    hits = {}
    for name, (s_, m_) in dict(pallas=(sp, mp), brute=(sb, mb)).items():
        h = hits[name] = tisect.intersect(s_, m_, to, td, 1e30, time=tt,
                                          device="cpu")
        np.testing.assert_array_equal(h["valid"].numpy(), m)
        for k in ("kind", "idx"):
            np.testing.assert_array_equal(h[k].numpy()[m],
                                          np.asarray(hj[k])[m])
        np.testing.assert_allclose(h["t"].numpy()[m], np.asarray(hj["t"])[m],
                                   rtol=1e-4, atol=1e-5)
    it = tisect.make_interaction(sp, mp, to, td, hits["pallas"], time=tt)
    ij = jisect.make_interaction(js, jm, jnp.asarray(o), jnp.asarray(d), hj,
                                 time=jnp.asarray(t))
    for k in ("p", "n", "ns"):
        np.testing.assert_allclose(it[k].numpy()[m], np.asarray(ij[k])[m],
                                   rtol=1e-4, atol=2e-5, err_msg=k)


def test_torch_lights_sampled_at_ray_time():
    """A moving point light and a moving emissive quad are sampled at the
    ray's shutter time, as in the JAX package."""
    def build(B, **kw):
        b = B()
        b.add_point_light([0, 5, 0], (10, 10, 10), velocity=(4, 0, 0))
        b.add_quad([-0.5, 4, -0.5], [1, 0, 0], [0, 0, 1],
                   emission=(5, 5, 5), velocity=(3, 0, 0))
        b.add_quad([-4, 0, -4], [8, 0, 0], [0, 0, 8],
                   material=b.add_diffuse((0.6, 0.6, 0.6)))
        b.set_camera([0, 3, -6], [0, 1, 0], math.radians(45), (8, 8),
                     shutter=(0.0, 1.0))
        return b.build(**kw)

    ts, _, tm = build(tbuilder.SceneBuilder, device="cpu")
    js, _, jm = build(JBuilder)
    assert tm.has_light_motion and tm.has_motion
    n = 4
    for lid in range(tm.n_lights):
        for tval in (0.0, 0.25, 1.0):
            want = jlights.light_sample(
                js, jm, jnp.full((n,), lid, jnp.int32), jnp.zeros((n, 3)),
                jnp.zeros((n,)), jnp.full((n, 2), 0.3), jnp.full((n,), tval))
            got = tlights.light_sample(
                ts, tm, torch.full((n,), lid), torch.zeros((n, 3)),
                torch.zeros((n,)), torch.full((n, 2), 0.3),
                torch.full((n,), tval))
            for k in ("p", "dir", "dist"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=(lid, tval, k))
    types = ts["light_type"].numpy()
    pt = int(np.nonzero(types == 3)[0][0])
    p1 = tlights.light_sample(ts, tm, torch.full((n,), pt),
                              torch.zeros((n, 3)), torch.zeros((n,)),
                              torch.zeros((n, 2)), torch.ones((n,)))["p"][0]
    np.testing.assert_allclose(p1.numpy(), [4, 5, 0], atol=1e-6)


@pytest.mark.parametrize("case", ["single_level", "moving"])
def test_torch_from_numpy_scene_single_level_and_moving(case):
    """A JAX scene on its single-level kernel, static or moving, carries
    across (velocities, shutter, tables of the same level) and both
    packages return the same intersect result."""
    v, f = _grid_mesh(52)
    b = JBuilder()
    b.add_mesh(v, f, material=b.add_diffuse((0.7, 0.5, 0.3)),
               velocity=(1.5, 0.0, 0.0) if case == "moving" else (0, 0, 0))
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera([0, 4, -7], [0, 0, 0], math.radians(40), (8, 8),
                 shutter=(0.0, 1.0))
    js, jc, jm = b.build(accel="pallas")
    ts, tc, tm = _carry(js, jc, jm)
    assert tm.accel == "pallas" and "pk_l1_base" not in ts
    assert tm.has_motion == (case == "moving")
    np.testing.assert_array_equal(ts["pk_slot2tri"].numpy(),
                                  np.asarray(js["pk_slot2tri"]))
    rng = np.random.default_rng(7)
    n = 256
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(1, 4, n),
                  rng.uniform(-4, 4, n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, n).astype(np.float32)
    hj = jisect.intersect(js, jm, jnp.asarray(o), jnp.asarray(d), 1e30,
                          time=jnp.asarray(t))
    ht = tisect.intersect(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                          1e30, time=torch.from_numpy(t), device="cpu")
    m = np.asarray(hj["valid"])
    assert m.sum() > 50
    np.testing.assert_array_equal(ht["valid"].numpy(), m)
    np.testing.assert_array_equal(ht["idx"].numpy()[m],
                                  np.asarray(hj["idx"])[m])
    np.testing.assert_allclose(ht["t"].numpy()[m], np.asarray(hj["t"])[m],
                               rtol=1e-5)
