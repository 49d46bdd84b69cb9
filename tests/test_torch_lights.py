"""The light-consistency tests of tests/test_lights.py:40-76 mirrored on
pathtracing_tpu_torch: for the environment-map lights (one, and two with
their own tables) and the function light, the path estimator (MIS + NEE)
and the simple one (BSDF sampling only) agree in the mean; a bias in a
light's sample / pdf pair would show as a gap far above the noise."""
import numpy as np
import torch

from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_torch_envlights import _base, _fn_sky, _sky

torch.set_num_threads(2)


def _consistency(b, rel_bound=0.15):
    """The JAX test's rule at 1/16 of its samples (12x12 pixels, 12 and
    24 spp against 24x24, 48 and 96), to keep the port's CPU renders
    short."""
    scene, cam, meta = b.build(device="cpu")
    img_p = t_render(scene, cam, meta, TConfig(
        spp=12, max_depth=4, integrator="path", regenerate=True,
        sampler=TSampler(x_samples=4, y_samples=3, seed=3)),
        device="cpu").numpy()
    img_s = t_render(scene, cam, meta, TConfig(
        spp=24, max_depth=4, integrator="simple", regenerate=True,
        sampler=TSampler(x_samples=6, y_samples=4, seed=4)),
        device="cpu").numpy()
    assert np.isfinite(img_p).all() and np.isfinite(img_s).all()
    rel = abs(img_p.mean() - img_s.mean()) / max(img_p.mean(), 1e-6)
    assert rel < rel_bound, f"estimator gap {rel:.3f}"


_RES = (12, 12)


def test_torch_env_texture_light_consistency():
    b = _base(TBuilder, _RES)
    b.add_env_light(b.textures.add_image(_sky(0, ((4, 8), (10, 14)))))
    _consistency(b)


def test_torch_two_env_lights_consistency():
    """Each env light's sample and pdf consult its own table."""
    b = _base(TBuilder, _RES)
    b.add_env_light(b.textures.add_image(_sky(1, ((2, 5), (4, 8)))))
    b.add_env_light(b.textures.add_image(_sky(2, ((10, 13), (20, 26)))))
    scene, _, meta = b.build(device="cpu")
    assert meta.n_env == 2
    slots = scene["light_env_slot"][:meta.n_lights].numpy()
    assert sorted(slots[slots >= 0].tolist()) == [0, 1]
    _consistency(b)


def test_torch_function_light_consistency():
    b = _base(TBuilder, _RES)
    b.add_function_inf_light(_fn_sky, nx=64, ny=32)
    _consistency(b)
