"""The dispatch sort key's kernel (csrc/sortkey.cu) against the plain
PyTorch key and the JAX package's key.

On the CPU the kernel's source is built as host code with g++
(accel/cubuild.py::host_library) and held bit for bit, on the same boxes
and rays, to scene/intersect.py's plain `_first_block_key` and to
pathtracing_tpu/scene/intersect.py's `_first_block_key` (the reference):
box counts on both sides of the 512-box chunk and the first-block-only
branch of huge tables, origins inside several boxes (ties at t = 0 across
chunk boundaries, held also to a hand-computed key), rays that miss every
box, axis-parallel and -0.0 direction components, a ray that enters a
padding box, and a NaN direction.  On the card (marker `cuda`) the kernel,
through `_first_block_key`, against the plain key at 65,280 lanes.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.accel import cubuild
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.utils import profile

MISS = 0x7FFFFFFE


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return tisect.bind_sort_key(cubuild.host_library(
        "sortkey", tmp_path_factory.mktemp("sortkey")))


@pytest.fixture(scope="module")
def jax_key():
    import jax.numpy as jnp
    from pathtracing_tpu.scene import intersect as jisect

    def key(lo, hi, o, d):
        k = jisect._first_block_key(
            dict(pk_blk_lo=jnp.asarray(lo), pk_blk_hi=jnp.asarray(hi)),
            jnp.asarray(o), jnp.asarray(d))
        return np.asarray(k).astype(np.int64)
    return key


def _boxes(rng, m):
    lo = rng.uniform(-50, 50, (m, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.5, 6.0, (m, 3)).astype(np.float32)


def _unit(d):
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _rays(rng, lo, hi, n):
    """A third aimed at box centres from outside, a third from inside a
    box (entered at t = 0, often with its neighbours), a third at random."""
    m = lo.shape[0]
    k = n // 3
    mid = (lo + hi) * 0.5
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    inside = rng.integers(0, m, n - 2 * k)
    o[2 * k:] = mid[inside]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:k] = mid[rng.integers(0, m, k)] - o[:k]
    return o, _unit(d)


def _tie_case():
    """Boxes 509-514 and 1021-1026 of 1,100 all hold the point (1, 1, 1);
    the rest lie far off.  A ray from that point enters those twelve at t
    = 0.  Chunk 0's best is 509 (its first) and its runner-up 510; chunk
    1's best 512 ties the running best, which stays 509, and takes the
    runner-up from 510 (a tie goes to the newer chunk's best); chunk 2's
    best 1024 takes it again.  So every such ray's key is (509 * m +
    1024) * 8 | octant."""
    rng = np.random.default_rng(11)
    m = 1100
    lo = rng.uniform(100, 200, (m, 3)).astype(np.float32)
    hi = lo + np.float32(1.0)
    for j in list(range(509, 515)) + list(range(1021, 1027)):
        lo[j] = rng.uniform(-3.0, 0.5, 3).astype(np.float32)
        hi[j] = rng.uniform(1.5, 4.0, 3).astype(np.float32)
    n = 96
    o = np.ones((n, 3), np.float32)
    d = _unit(rng.normal(size=(n, 3)).astype(np.float32))
    octant = ((d[:, 0] > 0) | (d[:, 1] > 0) << 1 | (d[:, 2] > 0) << 2)
    want = (509 * m + 1024) * 8 | octant.astype(np.int64)
    return lo, hi, o, d, want


def _within_chunk_case():
    """Two boxes of 40 hold the origin (boxes 3 and 7): best 3, runner-up
    7, ties to the lower index within a chunk."""
    rng = np.random.default_rng(12)
    m = 40
    lo = rng.uniform(100, 200, (m, 3)).astype(np.float32)
    hi = lo + np.float32(1.0)
    for j in (3, 7):
        lo[j], hi[j] = -1.0, 1.0
    o = np.zeros((32, 3), np.float32)
    d = _unit(rng.normal(size=(32, 3)).astype(np.float32))
    octant = ((d[:, 0] > 0) | (d[:, 1] > 0) << 1 | (d[:, 2] > 0) << 2)
    return lo, hi, o, d, (3 * m + 7) * 8 | octant.astype(np.int64)


def _padding_case():
    """513 boxes below the origin pad to 1,024 with 511 boxes at (3e37,
    3e37, 3e37).  A ray from (3, 3, 3) along (1, 1, 1) enters each at
    (3e37 - 3) * sqrt 3 ~ 5.2e37, under BIG: its best is padding box 513
    (the first) and its runner-up 514, clamped to m - 1 = 512.  A ray from
    (1, 1, 1), inside box 0, along the same direction keeps box 0 first
    and takes padding box 513 as the runner-up, clamped to 512 likewise."""
    rng = np.random.default_rng(13)
    m = 513
    lo = rng.uniform(-90, -20, (m, 3)).astype(np.float32)
    hi = lo + np.float32(2.0)
    lo[0], hi[0] = 0.0, 2.0
    d = _unit(np.ones((2, 3), np.float32))
    assert d[0, 0] == d[0, 1] == d[0, 2]
    o = np.array([[3, 3, 3], [1, 1, 1]], np.float32)
    want = np.array([(513 * m + 512) * 8 | 7, (0 * m + 512) * 8 | 7])
    return lo, hi, o, d, want


def _case(name):
    """(lo, hi, origin, direction, hand-computed key or None)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("m"):
        m = int(name[1:].split("_")[0])
        lo, hi = _boxes(rng, m)
        n = 240 if m > 4096 else 600
        return (lo, hi) + _rays(rng, lo, hi, n) + (None,)
    if name == "ties_across_chunks":
        return _tie_case()
    if name == "ties_within_chunk":
        return _within_chunk_case()
    if name == "padding_box":
        return _padding_case()
    lo, hi = _boxes(rng, 700)
    o, d = _rays(rng, lo, hi, 300)
    if name == "all_miss":
        o = np.full((300, 3), 80.0, np.float32)
        d = _unit(np.abs(rng.normal(size=(300, 3))).astype(np.float32))
        return lo, hi, o, d, np.full(300, MISS)
    if name == "axis_parallel_neg_zero":
        d[0::4, 0] = 0.0
        d[1::4, 1] = -0.0
        d[2::4, :2] = np.float32(-0.0)
        d[3::8, 2] = 1e-33                  # under the 1e-32 guard
        d[7::8, 2] = -1e-33
        return lo, hi, o, d, None
    if name == "nan_direction":
        d[::5] = np.nan
        d[1::5, 1] = np.nan
        return lo, hi, o, d, None
    raise KeyError(name)


CASES = ["m1", "m2", "m511", "m512", "m513", "m2563",
         "m16400_first_block_only", "ties_across_chunks",
         "ties_within_chunk", "padding_box", "all_miss",
         "axis_parallel_neg_zero", "nan_direction"]


@pytest.mark.parametrize("case", CASES)
def test_torch_sort_key_kernel_matches_plain(host_lib, jax_key, case):
    """The host-built kernel equals the plain key and the JAX package's
    key bit for bit (and a hand-computed key where the case has one)."""
    lo, hi, o, d, want = _case(case)
    tl, th = torch.from_numpy(lo), torch.from_numpy(hi)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = tisect.sort_key_launch(tl, th, to, td, lib=host_lib)
    ref = tisect._first_block_key(dict(pk_blk_lo=tl, pk_blk_hi=th), to, td)
    assert got.dtype == torch.int64 and got.shape == ref.shape
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), jax_key(lo, hi, o, d))
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), want)
    live = int((got != MISS).sum())
    if case.startswith("m") and case != "m1":
        assert 0 < live < len(got)           # both kinds of ray occur
    if case == "m16400_first_block_only":
        assert bool((got[got != MISS] < 16400 * 8).all())
    if case == "nan_direction":
        assert bool((got[::5] == MISS).all())


def test_torch_sort_key_kernel_strided_rays(host_lib):
    """Rays given as column slices of a wider tensor (rows 6 floats
    apart) key as their contiguous copies do."""
    lo, hi, o, d, _ = _case("m700_strided")
    wide = torch.from_numpy(np.concatenate([o, d], 1))
    tl, th = torch.from_numpy(lo), torch.from_numpy(hi)
    got = tisect.sort_key_launch(tl, th, wide[:, :3], wide[:, 3:],
                                 lib=host_lib)
    assert torch.equal(got, tisect._first_block_key_plain(
        dict(pk_blk_lo=tl, pk_blk_hi=th), torch.from_numpy(o),
        torch.from_numpy(d)))


@pytest.mark.parametrize("bad", ["float64_rays", "rays_n_by_4",
                                 "lengths_differ", "strided_table",
                                 "cpu_without_library"])
def test_torch_sort_key_wrapper_raises(host_lib, bad):
    """The wrapper refuses what the kernel does not take, before
    launching: another dtype, another width, origin and direction of two
    lengths, a box table that is not contiguous, CPU rays with no host
    library."""
    lo = torch.zeros((8, 3))
    hi = torch.ones((8, 3))
    o = torch.zeros((5, 3))
    d = torch.ones((5, 3))
    lib = host_lib
    if bad == "float64_rays":
        o = o.double()
    elif bad == "rays_n_by_4":
        o, d = torch.zeros((5, 4)), torch.ones((5, 4))
    elif bad == "lengths_differ":
        d = torch.ones((6, 3))
    elif bad == "strided_table":
        lo = torch.zeros((16, 3))[::2]
    else:
        lib = None
    with pytest.raises(ValueError):
        tisect.sort_key_launch(lo, hi, o, d, lib=lib)


@pytest.mark.cuda
def test_torch_sort_key_kernel_matches_plain_on_card():
    """On the card, _first_block_key is one kernel launch (the counter
    "sort_key.launches" rises by exactly 1), makes no synchronising CUDA
    call (under torch.cuda.set_sync_debug_mode("error") such a call
    raises), and equals the plain key run on the card and on the CPU, at
    the main path's 65,280 lanes, on 2,563 boxes with origins inside
    boxes and rays that miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort key kernel has no CPU "
                    "mode")
    rng = np.random.default_rng(21)
    lo, hi = _boxes(rng, 2563)
    o, d = _rays(rng, lo, hi, 65_280)
    cpu = dict(pk_blk_lo=torch.from_numpy(lo), pk_blk_hi=torch.from_numpy(hi))
    card = {k: v.cuda() for k, v in cpu.items()}
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    co, cd = to.cuda(), td.cuda()
    torch.cuda.synchronize()
    for _ in range(3):
        launches = profile.counters().get("sort_key.launches", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tisect._first_block_key(card, co, cd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert profile.counters()["sort_key.launches"] == launches + 1
    assert got.is_cuda and got.dtype == torch.int64
    assert torch.equal(got.cpu(), tisect._first_block_key(cpu, to, td))
    assert torch.equal(got, tisect._first_block_key_plain(card, co, cd))
    assert 0 < int((got != MISS).sum()) < 65_280
