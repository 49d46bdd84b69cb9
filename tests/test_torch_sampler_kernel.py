"""The sampler kernel (csrc/sampler.cu) against the JAX package's sampler
and the plain PyTorch sampler.

On the CPU the kernel's source is built as host code with g++
(accel/cubuild.py::host_library) and held bit for bit, on the same keys,
to pathtracing_tpu/core/rng.py (the reference) and to core/rng.py's plain
functions: hash_u32 over 1 to 6 keys mixing Python ints, 0-d and [n]
tensors (seeds at and above 2^31, negative ints, int32 keys), hash_float,
and sample_1d / sample_2d for stratified 4x4, 8x8 and 3x3 (not a power of
two: the per-lane rejection loop) and uniform, with dims as ints and as
per-lane tensors.  On the card (marker `cuda`) the kernel, through the
public functions, against the plain functions at 65,280 lanes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.core import rng as jr
from pathtracing_tpu_torch.accel import cubuild
from pathtracing_tpu_torch.core import rng
from pathtracing_tpu_torch.utils import profile

N = 4099            # lanes of a CPU case (not a multiple of a block)
SEED_HI = (1 << 31) + 977


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return rng.bind(cubuild.host_library(
        "sampler", tmp_path_factory.mktemp("sampler")))


def _lanes(n, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    px = torch.randint(0, 1920, (n,), generator=g)
    py = torch.randint(0, 1080, (n,), generator=g)
    dim = torch.randint(0, 1 << 12, (n,), generator=g)
    big = torch.randint(0, 1 << 40, (n,), generator=g)
    return [x.to(device) for x in (px, py, dim, big)]


def _jax_keys(keys):
    """The same keys for the JAX sampler: a tensor as its uint32 (the
    low 32 bits the port's samplers read), an int as it is."""
    return [jnp.asarray((k.to(torch.int64) & 0xFFFFFFFF).numpy()
                        .astype(np.uint32))
            if isinstance(k, torch.Tensor) else k for k in keys]


def _bits(x):
    """A result's bits as int64: a float32's int32 view, a u32 as held."""
    x = np.asarray(x)
    return (x.view(np.int32) if x.dtype == np.float32 else x).astype(np.int64)


def _hash_keys(k):
    px, py, dim, big = _lanes(N, seed=k)
    keys = (px, SEED_HI, torch.tensor(7), big, -5, dim.to(torch.int32))
    return keys[:k]


_HASH = [(f"hash_u32_{k}keys", "hash_u32", k) for k in range(1, 7)] + [
    ("hash_float_5keys", "hash_float", 5), ("hash_float_3keys",
                                            "hash_float", 3)]
_SAMPLERS = [(f"{op}_{kind}{xs}x{ys}_dim_{dk}", op, kind, xs, ys, dk)
             for op in ("sample_1d", "sample_2d")
             for kind, xs, ys in (("stratified", 4, 4), ("stratified", 8, 8),
                                  ("stratified", 3, 3), ("uniform", 4, 4))
             for dk in ("int", "lanes")]


@pytest.mark.parametrize(
    "case", [c[0] for c in _HASH] + [c[0] for c in _SAMPLERS])
def test_torch_sampler_kernel_matches_plain(host_lib, case):
    """The host-built kernel equals the JAX package's function on the
    same keys bit for bit, in shape, and the plain function bit for bit,
    in shape and dtype."""
    hashes = {c[0]: c for c in _HASH}
    if case in hashes:
        _, op, k = hashes[case]
        keys = _hash_keys(k)
        ref = getattr(rng, op + "_plain")(*keys)
        got = rng.launch(op, keys, lib=host_lib)
        want = getattr(jr, op)(*_jax_keys(keys))
    else:
        _, op, kind, xs, ys, dk = {c[0]: c for c in _SAMPLERS}[case]
        cfg = rng.SamplerConfig(kind=kind, x_samples=xs, y_samples=ys,
                                seed=SEED_HI + xs)
        px, py, dim, big = _lanes(N, seed=xs * 10 + ys)
        sidx = big % (xs * ys)          # every sample index below the count
        d = 1037 if dk == "int" else dim
        ref = getattr(rng, op + "_plain")(cfg, px, py, sidx, d)
        got = rng.launch(op, (px, py, sidx, d), cfg, lib=host_lib)
        jcfg = jr.SamplerConfig(kind=kind, x_samples=xs, y_samples=ys,
                                seed=SEED_HI + xs)
        want = getattr(jr, op)(jcfg, *_jax_keys((px, py, sidx, d)))
    assert tuple(want.shape) == tuple(got.shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.float32:
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["key_n_by_1", "lengths_differ", "nine_keys"])
def test_torch_sampler_wrapper_raises(host_lib, bad):
    """The wrapper refuses keys it cannot pass to the kernel before
    launching: a [n, 1] key, 1-D keys of two lengths, more keys than the
    kernel holds."""
    keys = {"key_n_by_1": (torch.zeros((8, 1), dtype=torch.int64), 3),
            "lengths_differ": (torch.zeros(8, dtype=torch.int64),
                               torch.zeros(9, dtype=torch.int64)),
            "nine_keys": tuple(range(9))}[bad]
    with pytest.raises(ValueError):
        rng.launch("hash_u32", keys, lib=host_lib)


@pytest.mark.cuda
def test_torch_sampler_kernel_matches_plain_on_card():
    """On the card, the public functions are one kernel launch each, make
    no synchronising CUDA call (under torch.cuda.set_sync_debug_mode
    "error" such a call raises), and equal the plain functions run on the
    card and on the CPU, at the main path's 65,280 lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sampler kernel has no CPU mode")
    n = 65_280
    px, py, dim, big = _lanes(n, seed=3, device="cuda")

    def cpu(xs):
        return [x.cpu() if isinstance(x, torch.Tensor) else x for x in xs]

    torch.cuda.synchronize()
    for kind, xs, ys in (("stratified", 4, 4), ("stratified", 3, 3),
                         ("uniform", 4, 4)):
        cfg = rng.SamplerConfig(kind=kind, x_samples=xs, y_samples=ys,
                                seed=SEED_HI)
        sidx = big % (xs * ys)
        for op in ("sample_1d", "sample_2d"):
            for d in (1037, dim):
                keys = (px, py, sidx, d)
                launches = profile.counters().get("rng.launches", 0)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = getattr(rng, op)(cfg, *keys)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                assert profile.counters()["rng.launches"] == launches + 1
                ref = getattr(rng, op + "_plain")(cfg, *cpu(keys))
                assert torch.equal(got.cpu().view(torch.int32),
                                   ref.view(torch.int32))
                if xs * ys & (xs * ys - 1) == 0:
                    # a power-of-two count: the plain version's division
                    # by a scalar is exact on the card too
                    on_card = getattr(rng, op + "_plain")(cfg, *keys)
                    assert torch.equal(got.view(torch.int32),
                                       on_card.view(torch.int32))
    keys = (px, SEED_HI, torch.tensor(7, device="cuda"), big, -5, dim)
    for op in ("hash_u32", "hash_float"):
        got = getattr(rng, op)(*keys)
        assert torch.equal(got, getattr(rng, op + "_plain")(*keys))
        assert torch.equal(got.cpu(), getattr(rng, op + "_plain")(
            *cpu(keys)))
    with pytest.raises(ValueError):
        rng.hash_u32(px[:, None], 3)
