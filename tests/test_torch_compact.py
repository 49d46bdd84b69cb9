"""Tail compaction (RenderConfig.compact_after) in the port's `trace`, both
forms: after compact_after bounces, on batches of 4,096 lanes or more, the
surviving lanes continue in a quarter-width batch and their radiance is
scattered back.  The RNG is keyed on (pixel, sample, bounce), so the image
and the gradients are the uncompacted ones; held against the port's
uncompacted render and the JAX package's compacted render
(tests/test_render_e2e.py's two compaction tests) on a 64 x 64 image, one
batch of 4,096 lanes.

Tolerances: compacted against uncompacted in the port, equal (the same
operations per lane); against the JAX package, film values to the repo's
render rule rtol=1e-4, atol=1e-5, gradients as in tests/test_torch_grad.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.integrators.render import render as j_render
from pathtracing_tpu.integrators.render import render_tile as j_render_tile
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu.sensor import film as jfilm
from pathtracing_tpu_torch.integrators import path as tpath
from pathtracing_tpu_torch.integrators.render import render, render_tile
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from pathtracing_tpu_torch.sensor import film as tfilm

from test_torch_grad import _cfgs, assert_grads_close, grad_scene

torch.set_num_threads(2)

RES = (64, 64)              # one batch of 4,096 lanes: compaction's minimum
COMPACT = 3
DEPTH = 6


def _cfg_pair(**kw):
    return _cfgs(**dict(dict(max_depth=DEPTH, differentiable=False), **kw))


class BatchWidths:
    """Records the lane count of every bounce the tracer builds."""

    def __init__(self, monkeypatch):
        self.widths = []
        make = tpath._make_bounce

        def spy(scene, meta, cfg, px, py, time, sample_idx, n, *a, **kw):
            self.widths.append(n)
            return make(scene, meta, cfg, px, py, time, sample_idx, n, *a,
                        **kw)
        monkeypatch.setattr(tpath, "_make_bounce", spy)


def _film_loss(scene, cam, meta, cfg):
    """The squared film sum of one sample over every pixel (the JAX test's
    loss) and its mat_base gradient."""
    leaf = scene["mat_base"].clone().requires_grad_()
    f = render_tile(dict(scene, mat_base=leaf), cam, meta, cfg,
                    tfilm.new_film(RES, device="cpu"),
                    torch.arange(RES[0] * RES[1]), 1)
    loss = (f["rgb"] * f["rgb"]).sum()
    loss.backward()
    return float(loss.detach()), leaf.grad.numpy()


@pytest.fixture(scope="module")
def scenes():
    return grad_scene(JBuilder, RES, glass=False), grad_scene(TBuilder, RES,
                                                              glass=False)


def test_torch_compaction_matches_full_width(scenes, monkeypatch):
    """The forward form: the compacted film is the full-width one, and the
    tail really ran at a quarter of the width."""
    _, (scene, cam, meta) = scenes
    _, cfg = _cfg_pair()
    full = render(scene, cam, meta, cfg, device="cpu")
    spy = BatchWidths(monkeypatch)
    comp = render(scene, cam, meta,
                  dataclasses.replace(cfg, compact_after=COMPACT),
                  device="cpu")
    assert spy.widths == [4096, 1024]
    torch.testing.assert_close(comp["rgb"], full["rgb"], rtol=0, atol=0)


def test_torch_differentiable_compaction_matches_full_width(scenes,
                                                            monkeypatch):
    """The scan form: value and mat_base gradients equal the uncompacted
    scan's."""
    _, (scene, cam, meta) = scenes
    _, cfg = _cfg_pair(differentiable=True)
    v0, g0 = _film_loss(scene, cam, meta, cfg)
    spy = BatchWidths(monkeypatch)
    v1, g1 = _film_loss(scene, cam, meta,
                        dataclasses.replace(cfg, compact_after=COMPACT))
    assert 1024 in spy.widths and 4096 in spy.widths
    assert v1 == v0
    np.testing.assert_array_equal(g1, g0)
    assert np.abs(g0).max() > 0


def test_torch_compaction_matches_jax(scenes):
    """The forward form against the JAX package's compacted render."""
    (jscene, jcam, jmeta), (scene, cam, meta) = scenes
    jcfg, cfg = (dataclasses.replace(c, compact_after=COMPACT)
                 for c in _cfg_pair())
    ref = np.asarray(j_render(jscene, jcam, jmeta, jcfg)["rgb"])
    got = render(scene, cam, meta, cfg, device="cpu")["rgb"].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_torch_differentiable_compaction_matches_jax(scenes):
    """The scan form's compaction against jax.grad of the JAX package's.
    Slow (~45 s, nearly all of it the JAX compile of both compaction
    branches); test_torch_differentiable_compaction_matches_full_width
    holds the port's form in the fast lane."""
    (jscene, jcam, jmeta), (scene, cam, meta) = scenes
    jcfg, cfg = (dataclasses.replace(c, compact_after=COMPACT)
                 for c in _cfg_pair(differentiable=True))
    # the reference without jax.checkpoint: the same gradients, a shorter
    # compile
    jcfg = dataclasses.replace(jcfg, remat=False)
    pix = jnp.arange(RES[0] * RES[1], dtype=jnp.int32)

    def loss(base):
        f = j_render_tile(dict(jscene, mat_base=base), jcam, jmeta, jcfg,
                          jfilm.new_film(RES), pix, 1)
        return jnp.sum(f["rgb"] * f["rgb"])
    v_ref, g_ref = jax.value_and_grad(loss)(jscene["mat_base"])
    val, grad = _film_loss(scene, cam, meta, cfg)
    np.testing.assert_allclose(val, float(v_ref), rtol=1e-4)
    assert_grads_close([grad], [np.asarray(g_ref)], ["mat_base"])
