"""Texture pool and evaluation of pathtracing_tpu_torch against the JAX
package's (scene/textures.py): the same pool built from seeded numpy
images, the same ids and uvs through both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.scene import textures as jtex
from pathtracing_tpu_torch.scene import textures as ttex

torch.set_num_threads(2)


def _pools():
    """RGBA image, RGB image, solid, checker of the two images, uv debug,
    an sRGB uint8 image and a 1-channel image, in both packages."""
    rng = np.random.default_rng(4)
    rgba = rng.random((12, 16, 4)).astype(np.float32)
    rgb = rng.random((8, 5, 3)).astype(np.float32)
    srgb8 = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    gray = rng.random((4, 7)).astype(np.float32)
    pools = []
    for mod in (jtex, ttex):
        pool = mod.TexturePool()
        a = pool.add_image(rgba, color_scale=(0.9, 1.0, 1.1))
        b = pool.add_image(rgb)
        pool.add_solid((0.2, 0.4, 0.6), color_scale=(1.0, 0.5, 2.0))
        pool.add_checker(a, b, uv_scale=(0.25, 0.5),
                         color_scale=(1.0, 0.8, 0.6))
        pool.add_uv_debug()
        pool.add_image(srgb8, srgb=True)
        pool.add_image(gray)
        pools.append(pool)
    return pools


def _queries(n=600):
    rng = np.random.default_rng(5)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    # exact texel edges and centres of the 16x12 and 5x8 images, and the
    # wrap seams
    uv[:40, 0] = (np.arange(40) - 8) / 16.0
    uv[40:80, 1] = (np.arange(40) - 8) / 12.0
    uv[80:120, 0] = (np.arange(40) - 8 + 0.5) / 5.0
    uv[120:124] = [[0, 0], [1, 1], [-1, 2], [0.5, -0.5]]
    ids = rng.integers(-1, 7, n).astype(np.int32)
    return ids, uv


def test_torch_texture_pool_packs_like_jax():
    jp, tp = _pools()
    ja, ta = jp.pack(), tp.pack()
    assert set(ja) == set(ta) == {"tex_texels", "tex_info_i", "tex_info_f"}
    for k in ta:
        assert ta[k].dtype == np.asarray(ja[k]).dtype, k
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    # a pool rebuilt from the packed arrays packs to the same arrays
    again = ttex.TexturePool.from_packed(**{k[4:]: v for k, v in ta.items()}
                                         ).pack()
    for k in ta:
        np.testing.assert_array_equal(again[k], ta[k], err_msg=k)
    # an empty pool packs to the same one-row stand-ins
    je, te = jtex.TexturePool().pack(), ttex.TexturePool().pack()
    for k in te:
        np.testing.assert_array_equal(te[k], np.asarray(je[k]), err_msg=k)


@pytest.mark.parametrize("fn", ["texture_eval", "texture_alpha"])
def test_torch_texture_eval_matches_jax(fn):
    """rtol=1e-6, atol=1e-7: the same float32 bilinear weights and texels;
    the compiled reference may contract the weighted sum's multiply-adds."""
    jp, tp = _pools()
    ids, uv = _queries()
    jt = {k: jnp.asarray(v) for k, v in jp.pack().items()}
    tt = {k: torch.from_numpy(v) for k, v in tp.pack().items()}
    want = np.asarray(getattr(jtex, fn)(jt, jnp.asarray(ids),
                                        jnp.asarray(uv)))
    got = getattr(ttex, fn)(tt, torch.from_numpy(ids),
                            torch.from_numpy(uv)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if fn == "texture_alpha":
        # only the 4-channel image (id 0; id -1 clips to it) carries alpha
        assert (got[ids > 0] == 1.0).all() and (got[ids == 0] < 1.0).any()


def test_torch_texture_negative_coords_wrap_by_floor_mod():
    """A texel coordinate of -1 reads the last texel, not texel 1."""
    pool = ttex.TexturePool()
    img = np.zeros((1, 4, 3), np.float32)
    img[0, :, 0] = [0.0, 1.0, 2.0, 3.0]
    pool.add_image(img)
    tt = {k: torch.from_numpy(v) for k, v in pool.pack().items()}
    # u = -1/8: x = -1.0 exactly -> texel -1 wraps to texel 3
    got = ttex.texture_eval(tt, torch.zeros(1, dtype=torch.int32),
                            torch.tensor([[-0.125, 0.5]]))
    assert float(got[0, 0]) == 3.0
