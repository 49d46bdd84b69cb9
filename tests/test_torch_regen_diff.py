"""The port's differentiable persistent wavefront
(integrators/regen_diff.py, trace_regen_diff as a torch.autograd.Function)
against the JAX package's trace_regen_diff and the port's own scan form
and trace_regen, on tests/test_torch_grad.py's scene with a queue of two
waves drained by half as many lanes as pixels (several refills per lane);
the scene's glass sphere is left out here (it doubles the JAX compile;
tests/test_torch_grad.py holds the dielectric's gradients).

Tolerances: the recording forward's radiance equals trace_regen's bit for
bit; against the JAX package, radiance is held to the repo's render rule,
rtol=1e-4, atol=1e-5 (here on every value), and gradients, as in
tests/test_torch_grad.py, to rtol=1e-4, atol=1e-5 x the largest gradient;
against the port's scan form, values to rtol=1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.integrators.regen_diff import \
    trace_regen_diff as j_regen_diff
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators import path as tpath
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.regen_diff import (split_scene,
                                                          trace_regen_diff)
from pathtracing_tpu_torch.integrators.render import render
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder

from test_torch_grad import (PARAMS, RES, VALUE_RTOL, TraversalCalls,
                             _cfgs, assert_grads_close, grad_scene,
                             port_scan_loss)

torch.set_num_threads(2)

WAVES = 2
LANES = RES[0] * RES[1] // 2


def port_regen_loss(scene, cam, meta, cfg, names, stats=None):
    leaves = {k: scene[k].clone().requires_grad_() for k in names}
    out = trace_regen_diff(dict(scene, **leaves), cam, meta, cfg,
                           torch.arange(RES[0] * RES[1]), WAVES, 0,
                           lanes=LANES, device="cpu", stats=stats)
    loss = out.sum()
    loss.backward()
    return out.detach(), [leaves[k].grad.numpy() for k in names]


@pytest.fixture(scope="module")
def regen_pair():
    """The scene in both packages and the JAX trace_regen_diff's value and
    gradients (computed once: the JAX compile dominates this module)."""
    jscene, jcam_, jmeta = grad_scene(JBuilder, glass=False)
    jcfg, tcfg = (dataclasses.replace(c, differentiable=False)
                  for c in _cfgs())
    pix = jnp.arange(RES[0] * RES[1], dtype=jnp.int32)

    def loss(*vals):
        sc = dict(jscene, **dict(zip(PARAMS, vals)))
        out = j_regen_diff(sc, jcam_, jmeta, jcfg, pix, WAVES, 0,
                           lanes=LANES)
        return jnp.sum(out), out
    (_, out), g = jax.value_and_grad(
        loss, argnums=tuple(range(len(PARAMS))), has_aux=True)(
            *(jscene[k] for k in PARAMS))
    scene, cam, meta = grad_scene(TBuilder, glass=False)
    stats = {}
    got = port_regen_loss(scene, cam, meta, tcfg, PARAMS, stats)
    return (scene, cam, meta), tcfg, (np.asarray(out),
                                      [np.asarray(x) for x in g]), got, stats


def test_torch_regen_diff_value_is_trace_regen(regen_pair):
    """The recording forward runs trace_regen's loop with the same
    kernels in the same order: the same radiance, bit for bit."""
    (scene, cam, meta), cfg, _, (out, _), _ = regen_pair
    ref = tpath.trace_regen(scene, cam, meta, cfg,
                            torch.arange(RES[0] * RES[1]), WAVES, 0,
                            lanes=LANES, device="cpu")
    assert torch.equal(out, ref)


def test_torch_regen_diff_value_matches_jax(regen_pair):
    _, _, (j_out, _), (out, _), _ = regen_pair
    np.testing.assert_allclose(out.numpy(), j_out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", PARAMS)
def test_torch_regen_diff_gradients_match_jax(regen_pair, name):
    """Material, texel and light gradients through the custom backward
    equal the JAX package's custom VJP."""
    _, _, (_, j_grads), (_, grads), _ = regen_pair
    i = PARAMS.index(name)
    assert_grads_close([grads[i]], [j_grads[i]], [name])
    assert np.abs(grads[i]).sum() > 0


def test_torch_regen_diff_gradients_match_scan_form(regen_pair):
    """The same sample population through the port's scan form (one
    trace per wave): the same value and gradients."""
    (scene, cam, meta), cfg, _, (out, grads), _ = regen_pair
    scan_cfg = dataclasses.replace(cfg, differentiable=True)
    total, scan_grads = 0.0, [0.0] * len(PARAMS)
    for wave in range(WAVES):
        val, g = port_scan_loss(scene, cam, meta, scan_cfg, PARAMS, RES,
                                wave)
        total += val
        scan_grads = [a + b for a, b in zip(scan_grads, g)]
    np.testing.assert_allclose(float(out.sum()), total, rtol=VALUE_RTOL)
    assert_grads_close(grads, scan_grads, PARAMS)


def test_torch_regen_diff_residuals_are_small(regen_pair):
    """The backward pass keeps at most the reference's ~73 B per lane per
    iteration (integrators/regen_diff.py of the JAX package)."""
    *_, stats = regen_pair
    per = stats["residual_bytes"] / (stats["iterations"] * stats["lanes"])
    assert stats["lanes"] == LANES and stats["iterations"] > 2 * WAVES
    assert per <= 73


def test_torch_regen_diff_backward_calls_no_traversal(regen_pair,
                                                      monkeypatch):
    (scene, cam, meta), cfg, *_ = regen_pair
    count = TraversalCalls(monkeypatch)
    leaf = scene["mat_base"].clone().requires_grad_()
    stats = {}
    out = trace_regen_diff(dict(scene, mat_base=leaf), cam, meta, cfg,
                           torch.arange(RES[0] * RES[1]), WAVES, 0,
                           lanes=LANES, device="cpu", stats=stats)
    forward_calls = count.calls
    out.sum().backward()
    assert forward_calls == 2 * stats["iterations"]
    assert count.calls == forward_calls
    assert torch.isfinite(leaf.grad).all()


def test_torch_render_differentiable_regen_matches_scan(regen_pair):
    """render(differentiable=True, regenerate=True) drains through
    trace_regen_diff; its film and gradients equal the scan render's."""
    (scene, cam, meta), _, *_ = regen_pair
    kw = dict(spp=2, max_depth=3, integrator="path", differentiable=True,
              rays_per_batch=48, sampler=TSampler(x_samples=4, y_samples=2,
                                                  seed=9))
    res = {}
    for regen in (True, False):
        leaf = scene["mat_base"].clone().requires_grad_()
        film = render(dict(scene, mat_base=leaf), cam, meta,
                      TConfig(regenerate=regen, **kw), device="cpu")
        film["rgb"].sum().backward()
        res[regen] = (film["rgb"].detach(), leaf.grad.numpy())
    torch.testing.assert_close(res[True][0], res[False][0], rtol=1e-5,
                               atol=1e-6)
    assert_grads_close([res[True][1]], [res[False][1]], ["mat_base"])
    assert np.abs(res[True][1]).sum() > 0


def test_torch_regen_diff_refuses_media(regen_pair):
    (scene, cam, meta), cfg, *_ = regen_pair
    with pytest.raises(NotImplementedError, match="media"):
        trace_regen_diff(scene, cam, meta,
                         dataclasses.replace(cfg, integrator="volpath"),
                         torch.arange(8), 1, 0, device="cpu")


def test_torch_split_scene_prefixes(regen_pair):
    (scene, *_), *_ = regen_pair
    diff, rest = split_scene(scene)
    assert set(diff) | set(rest) == set(scene)
    assert "mat_base" in diff and "tex_texels" in diff
    assert "light_color" in diff and "tri_v" in rest and "sph_c" in rest
    assert all(k.startswith(("mat_", "tex_", "light_", "med_", "env_"))
               for k in diff)
