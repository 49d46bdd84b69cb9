"""Gradients through the port's renderer: the differentiable scan form of
`trace` (integrators/path.py, differentiable=True, with and without the
per-bounce checkpoint), its tail compaction, and volpath, against jax.grad
of the JAX package's scan form on the same scenes and sample streams;
autograd against central finite differences; the backward pass calls no
traversal; the inverse-rendering tool lowers its loss.

Tolerances: the JAX package's own gradient comparisons allow rtol=2e-3,
atol=2e-4 x the largest gradient (tests/test_regen_diff.py); the port
computes the same float32 operations in the same order, so values are held
to rtol=1e-5 and gradients to rtol=1e-4, atol=1e-5 x the largest gradient
here.  Finite differences keep the JAX test's rtol=0.08, atol=1e-4
(tests/test_gradients.py).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators import path as jpath
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu.sensor import camera as jcam
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators import path as tpath
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_tile
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from pathtracing_tpu_torch.sensor import camera as tcam
from pathtracing_tpu_torch.sensor import film as tfilm

torch.set_num_threads(2)

RES = (12, 9)
DEPTH = 3
PARAMS = ("mat_base", "tex_texels", "light_color")
VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def grad_scene(B, res=RES, glass=True):
    """tests/test_regen_diff.py's scene with a textured floor and (glass)
    a rough glass sphere (so the dielectric's detached half-vector is
    exercised), built by either package's builder (B)."""
    b = B()
    rng = np.random.default_rng(7)
    tid = b.textures.add_image(rng.uniform(0.2, 0.9, (8, 8, 3))
                               .astype(np.float32))
    b.add_quad([-8, 0, -8], [16, 0, 0], [0, 0, 16],
               material=b.add_diffuse((0.65, 0.6, 0.55), base_tex=tid))
    b.add_sphere([0, 1, 0], 1.0,
                 material=b.add_diffuse((0.5, 0.3, 0.25), roughness=0.6))
    b.add_sphere([2.2, 0.8, -1.0], 0.8,
                 material=b.add_conductor((0.9, 0.7, 0.4)))
    if glass:
        b.add_sphere([-2.0, 0.7, -1.5], 0.7,
                     material=b.add_dielectric(ior=1.5, roughness=0.3))
    b.add_quad([-1, 4, -1], [2, 0, 0], [0, 0, 2],
               emission=(14.0, 12.0, 10.0), one_sided=True)
    b.add_uniform_inf_light((0.3, 0.4, 0.55))
    b.set_camera([0, 2.5, -7], [0, 1, 0], math.radians(45), res)
    return b.build() if B is JBuilder else b.build(device="cpu")


SAMPLER = dict(x_samples=4, y_samples=2, seed=9)


def lanes(res, wave):
    """Every pixel of `res` at sample `wave`, as (numpy px, py, sidx)."""
    w, h = res
    pix = np.arange(w * h)
    return pix % w, pix // w, np.full(w * h, wave)


def jax_scan_loss(scene, cam, meta, cfg, names, res, wave=0):
    """jax.value_and_grad of the summed radiance of the JAX scan form over
    every pixel at sample `wave`, in the parameter arrays `names`."""
    px, py, sidx = (jnp.asarray(a, jnp.int32) for a in lanes(res, wave))
    sidx = sidx.astype(jnp.uint32)
    o, d, tm, _ = jcam.camera_lanes(cam, cfg.sampler, px, py, sidx)

    def loss(*vals):
        sc = dict(scene, **dict(zip(names, vals)))
        return jnp.sum(jpath.trace(sc, cam, meta, cfg, o, d, tm, px, py,
                                   sidx))
    val, g = jax.value_and_grad(loss, argnums=tuple(range(len(names))))(
        *(scene[k] for k in names))
    return float(val), [np.asarray(x) for x in g]


def port_scan_loss(scene, cam, meta, cfg, names, res, wave=0):
    """The port's counterpart of jax_scan_loss (autograd)."""
    px, py, sidx = (torch.from_numpy(a) for a in lanes(res, wave))
    o, d, tm, _ = tcam.camera_lanes(cam, cfg.sampler, px, py, sidx)
    leaves = {k: scene[k].clone().requires_grad_() for k in names}
    li = tpath.trace(dict(scene, **leaves), cam, meta, cfg, o, d, tm, px, py,
                     sidx, device="cpu")
    loss = li.sum()
    loss.backward()
    return float(loss.detach()), [leaves[k].grad.numpy() for k in names]


def assert_grads_close(got, ref, names):
    for name, g, r in zip(names, got, ref):
        assert np.isfinite(g).all(), name
        scale = np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def _cfgs(**kw):
    kw = dict(dict(spp=1, max_depth=DEPTH, integrator="path",
                   differentiable=True), **kw)
    return (JConfig(sampler=JSampler(**SAMPLER), **kw),
            TConfig(sampler=TSampler(**SAMPLER), **kw))


@pytest.fixture(scope="module")
def scan_pair():
    """The scene in both packages and the JAX scan form's value and
    gradients (computed once: the JAX compile dominates this module)."""
    jscene, jcam_, jmeta = grad_scene(JBuilder)
    tscene = grad_scene(TBuilder)
    # the reference without jax.checkpoint: the same gradients, a shorter
    # compile
    jcfg, _ = _cfgs(remat=False)
    ref = jax_scan_loss(jscene, jcam_, jmeta, jcfg, PARAMS, RES)
    return tscene, ref


def test_torch_grad_scene_arrays_match_jax(scan_pair):
    (scene, _, meta), _ = scan_pair
    jscene, _, jmeta = grad_scene(JBuilder)
    for k in ("mat_base", "mat_rough", "tex_texels", "light_color",
              "sph_c", "quad_q"):
        np.testing.assert_array_equal(scene[k].numpy(), np.asarray(jscene[k]),
                                      err_msg=k)
    assert meta.mats_present == jmeta.mats_present


@pytest.mark.parametrize("remat", [True, False])
def test_torch_scan_gradients_match_jax(scan_pair, remat):
    """mat_base, texel and light gradients of the scan form (with the
    per-bounce checkpoint and without it) equal jax.grad's."""
    (scene, cam, meta), (v_ref, g_ref) = scan_pair
    _, cfg = _cfgs(remat=remat)
    val, grads = port_scan_loss(scene, cam, meta, cfg, PARAMS, RES)
    np.testing.assert_allclose(val, v_ref, rtol=VALUE_RTOL)
    assert_grads_close(grads, g_ref, PARAMS)
    assert np.abs(grads[0]).sum() > 0 and np.abs(grads[1]).sum() > 0


def test_torch_scan_value_matches_forward(scan_pair):
    """The scan form's radiance is the forward tracer's (the scan only
    runs the dead lanes' bounces as well, which change nothing)."""
    (scene, cam, meta), _ = scan_pair
    _, cfg = _cfgs()
    px, py, sidx = (torch.from_numpy(a) for a in lanes(RES, 0))
    o, d, tm, _ = tcam.camera_lanes(cam, cfg.sampler, px, py, sidx)
    fwd = tpath.trace(scene, cam, meta,
                      dataclasses.replace(cfg, differentiable=False), o, d,
                      tm, px, py, sidx, device="cpu")
    scan = tpath.trace(scene, cam, meta, cfg, o, d, tm, px, py, sidx,
                       device="cpu")
    torch.testing.assert_close(scan, fwd, rtol=0, atol=0)


class TraversalCalls:
    """Counts the closest-hit passes and shadow predicates the integrator
    runs (its module-level _intersect / _occluded)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in ("_intersect", "_occluded"):
            fn = getattr(tpath, name)
            monkeypatch.setattr(tpath, name, self._counted(fn))

    def _counted(self, fn):
        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return wrapped


@pytest.mark.parametrize("remat", [True, False])
def test_torch_scan_backward_calls_no_traversal(scan_pair, monkeypatch,
                                                remat):
    """The forward pass traces; the backward pass (with the checkpoint's
    recomputation) replays shade math only."""
    (scene, cam, meta), _ = scan_pair
    _, cfg = _cfgs(remat=remat)
    count = TraversalCalls(monkeypatch)
    px, py, sidx = (torch.from_numpy(a) for a in lanes(RES, 0))
    o, d, tm, _ = tcam.camera_lanes(cam, cfg.sampler, px, py, sidx)
    base = scene["mat_base"].clone().requires_grad_()
    loss = tpath.trace(dict(scene, mat_base=base), cam, meta, cfg, o, d, tm,
                       px, py, sidx, device="cpu").sum()
    forward_calls = count.calls
    loss.backward()
    assert forward_calls == 2 * DEPTH          # one of each per bounce
    assert count.calls == forward_calls
    assert torch.isfinite(base.grad).all() and base.grad.abs().sum() > 0


def _fd_scene(B):
    b = B()
    m = b.add_diffuse((0.6, 0.5, 0.4), roughness=1.0)
    b.add_sphere([0, 0, 0], 1.0, material=m)
    b.add_quad([-4, -1, -4], [8, 0, 0], [0, 0, 8],
               material=b.add_diffuse((0.4, 0.4, 0.4), roughness=1.0))
    b.add_quad([-1, 4, -1], [2, 0, 0], [0, 0, 2], emission=(8, 8, 8))
    b.add_uniform_inf_light((0.2, 0.25, 0.3))
    b.set_camera([0, 1.5, -5], [0, 0, 0], math.radians(35), (8, 8))
    return b.build(device="cpu")


@pytest.mark.parametrize("key,eps", [("mat_base", 1e-2),
                                     ("light_color", 1e-1)])
def test_torch_ad_matches_finite_differences(key, eps):
    """tests/test_gradients.py's check on the port: diffuse-only materials
    and depth below the Russian-roulette start, so no discrete decision
    flips and the estimator is smooth in the parameters."""
    scene, cam, meta = _fd_scene(TBuilder)
    cfg = TConfig(spp=4, max_depth=3, integrator="path", differentiable=True,
                  rr_start=10, sampler=TSampler(x_samples=2, y_samples=2,
                                                seed=3))
    pix = torch.arange(64)

    def loss(val):
        f = tfilm.new_film(cam["resolution"], device="cpu")
        f = render_tile(dict(scene, **{key: val}), cam, meta, cfg, f, pix, 4)
        img = f["rgb"] / torch.clamp(f["weight"], min=1e-12)[:, None]
        return img.mean()

    val0 = scene[key].clone().requires_grad_()
    loss(val0).backward()
    g_ad = val0.grad.numpy()
    with torch.no_grad():
        for lin in np.argsort(np.abs(g_ad).ravel())[-2:]:
            idx = np.unravel_index(lin, g_ad.shape)
            basis = torch.zeros_like(val0)
            basis[idx] = 1.0
            fd = (float(loss(scene[key] + eps * basis))
                  - float(loss(scene[key] - eps * basis))) / (2 * eps)
            assert np.isfinite(fd)
            np.testing.assert_allclose(g_ad[idx], fd, rtol=0.08, atol=1e-4,
                                       err_msg=str((key, idx)))


def glowing_fog_scene(B, res=(8, 8)):
    """A fog sphere (a material-less boundary) over a floor in a thin
    haze, lit only by the media's own emission: a scene without lights, so
    the JAX package can differentiate its volpath scan (with a light, its
    shadow rays march through a while_loop, which reverse mode refuses)."""
    b = B()
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.4, 0.3, 0.2),
                       g=0.3, le=(2.0, 1.5, 1.0), le_density=1.0)
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    b.add_quad([-20, 0, -20], [40, 0, 0], [0, 0, 40], material=white)
    b.add_sphere([0, 2, 0], 2.0, medium=fog)
    b.set_scene_medium(b.add_medium(sigma_a=(0.01, 0.01, 0.01),
                                     sigma_s=(0.05, 0.05, 0.05), g=0.0,
                                     le=(0.1, 0.1, 0.1)))
    b.set_camera(look_from=[0, 3, -10], look_at=[0, 2, 0],
                 fov=math.radians(40.0), resolution=res)
    return b.build() if B is JBuilder else b.build(device="cpu")


VOL_NAMES = ("med_sigma_t", "med_sigma_s", "med_le", "mat_base")


@pytest.fixture(scope="module")
def volpath_pair():
    res = (8, 8)
    jscene, jcam_, jmeta = glowing_fog_scene(JBuilder, res)
    kw = dict(spp=1, max_depth=DEPTH, integrator="volpath",
              differentiable=True)
    jcfg = JConfig(sampler=JSampler(x_samples=2, y_samples=1, seed=5), **kw)
    tcfg = TConfig(sampler=TSampler(x_samples=2, y_samples=1, seed=5), **kw)
    assert jmeta.n_lights == 0 and jmeta.n_media == 2
    ref = jax_scan_loss(jscene, jcam_, jmeta, jcfg, VOL_NAMES, res)
    return glowing_fog_scene(TBuilder, res), tcfg, res, ref


@pytest.mark.parametrize("remat", [True, False])
def test_torch_volpath_scan_gradients_match_jax(volpath_pair, remat):
    """Differentiable volpath goes through the scan form: its gradients
    reach the media arrays and equal jax.grad's."""
    (scene, cam, meta), cfg, res, (v_ref, g_ref) = volpath_pair
    cfg = dataclasses.replace(cfg, remat=remat)
    val, grads = port_scan_loss(scene, cam, meta, cfg, VOL_NAMES, res)
    np.testing.assert_allclose(val, v_ref, rtol=VALUE_RTOL)
    assert_grads_close(grads, g_ref, VOL_NAMES)
    for g in grads[:3]:
        assert np.abs(g).sum() > 0


def test_torch_volpath_gradients_match_finite_differences():
    """On a lit medium scene (shadow rays march through the media; the JAX
    package cannot differentiate this one), the scattering coefficient's
    gradient matches central finite differences: sigma_s enters the
    estimator only through its weights, never through a sampling decision
    (distances are sampled from sigma_t)."""
    scene, cam, meta = tscenes.spheres_medium(resolution=(8, 8),
                                              device="cpu")
    cfg = TConfig(spp=2, max_depth=3, integrator="volpath",
                  differentiable=True, rr_start=10,
                  sampler=TSampler(x_samples=2, y_samples=1, seed=5))
    pix = torch.arange(64)

    def loss(sig_s):
        f = tfilm.new_film(cam["resolution"], device="cpu")
        f = render_tile(dict(scene, med_sigma_s=sig_s), cam, meta, cfg, f,
                        pix, 2)
        return f["rgb"].sum()

    val0 = scene["med_sigma_s"].clone().requires_grad_()
    loss(val0).backward()
    g_ad = val0.grad.numpy()
    assert np.isfinite(g_ad).all() and np.abs(g_ad).sum() > 0
    eps = 1e-3
    with torch.no_grad():
        for lin in np.argsort(np.abs(g_ad).ravel())[-2:]:
            idx = np.unravel_index(lin, g_ad.shape)
            basis = torch.zeros_like(val0)
            basis[idx] = eps
            fd = (float(loss(scene["med_sigma_s"] + basis))
                  - float(loss(scene["med_sigma_s"] - basis))) / (2 * eps)
            np.testing.assert_allclose(g_ad[idx], fd, rtol=0.08, atol=1e-4,
                                       err_msg=str(idx))


def test_torch_recording_bounce_refuses_media(volpath_pair):
    (scene, cam, meta), cfg, _, _ = volpath_pair
    px = torch.zeros(4, dtype=torch.int64)
    for kw in (dict(record=True), dict(replay={})):
        with pytest.raises(NotImplementedError, match="media"):
            tpath._make_bounce(scene, meta, cfg, px, px, None, px, 4, **kw)


def test_torch_inverse_rendering_lowers_the_loss():
    """tools/inverse_rendering.py at a tiny size: a few steps of gradient
    descent move the albedos toward the target's and lower the loss."""
    from pathtracing_tpu_torch.tools import inverse_rendering as inv
    hist = inv.main(["--device", "cpu", "--res", "12", "--steps", "6",
                     "--spp", "2", "--depth", "2", "--quiet"])
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < 0.5 * hist["loss"][0]
    assert hist["albedo_err"][-1] < hist["albedo_err"][0]
