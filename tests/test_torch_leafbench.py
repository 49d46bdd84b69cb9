"""K4, the leaf-test micro-benchmark (pathtracing_tpu_torch/tools/
bench_leaf.py + csrc/leaf.cu), against the JAX package's
tools/bench_mxu_leaf.py run in interpret mode on the CPU.  The JAX tool is
imported by path; nothing in tools/ changes."""
import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.accel import cubuild
from pathtracing_tpu_torch.tools import bench_leaf as bl

torch.set_num_threads(2)

K2, N_ITER = 16, 16
_TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_mxu_leaf.py"


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("bench_mxu_leaf", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return bl.make_inputs(K2)


def _jax_out(jax_tool, mode, inp):
    _, out = jax_tool.run_mode(mode, *(jnp.asarray(inp[k]) for k in (
        "tri", "trib", "rays", "tri_hbm")), K2, N_ITER)
    return np.asarray(out).reshape(-1)


def _rel(a, b):
    return np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1e-3)


@pytest.mark.parametrize("mode", bl.MODES)
def test_torch_leaf_plain_matches_jax_tool(jax_tool, inputs, mode):
    """Each mode's plain version (what leaf_run runs on CPU tensors)
    against the JAX tool's kernel in interpret mode, K2=16, n_iter=16.
    vpu*: rtol 1e-6 (the two packages round a few sums differently).
    mxu_hi: rtol 1e-5 (both products in float32).  mxu_3x: rtol 1e-5 (the
    bf16x3 split carries ~16 mantissa bits per operand, against XLA's
    float32 product).  mxu_1x: XLA on the CPU runs a DEFAULT-precision dot
    in float32, while the port rounds both operands to bf16 as the TPU
    does, so t moves by the bf16 rounding of det and t*det: where both hit
    it stays within 10% (measured 6.6%), and a ray grazing an edge may hit
    in one and miss in the other (hit flags agree on >= 95% of rays)."""
    want = _jax_out(jax_tool, mode, inputs)
    tabs = bl.kernel_tables(inputs, "cpu")
    got = bl.leaf_run(mode, tabs, K2, N_ITER).numpy()
    assert np.array_equal(got, bl.leaf_plain(mode, tabs, K2, N_ITER).numpy())
    hits = want < 1e29
    assert 5 < hits.sum() < 128
    if mode == "mxu_1x":
        both = hits & (got < 1e29)
        assert (hits == (got < 1e29)).mean() >= 0.95
        assert _rel(got[both], want[both]).max() < 0.1
        return
    rtol = 1e-6 if mode.startswith("vpu") else 1e-5
    np.testing.assert_array_equal(got < 1e29, hits)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_torch_leaf_inputs_are_the_tool_construction(jax_tool, inputs):
    """make_inputs builds the JAX tool's tables: the determinant form's B
    gives det, t*det, u*det and v*det of Moller-Trumbore (checked against
    the vpu plain version's hits), and the streamed table is the resident
    one plus 1e-3 noise."""
    tabs = bl.kernel_tables(inputs, "cpu")
    assert tabs["tri_rows"].shape == (K2, 12)
    assert tabs["hbm_rows"].shape == (bl.N_BLK * K2, 12)
    assert np.abs(inputs["tri_hbm"].reshape(16, bl.N_BLK, K2)
                  - inputs["tri"][:, None]).max() < 1e-2
    vpu = bl.leaf_plain("vpu", tabs, K2, 1)
    hi = bl.leaf_plain("mxu_hi", tabs, K2, 1)
    np.testing.assert_allclose(hi.numpy(), vpu.numpy(), rtol=1e-4)


@pytest.fixture(scope="module")
def host_leaf(tmp_path_factory):
    """csrc/leaf.cu's scalar modes compiled as plain C++ at each lane count
    the kernel can be built for (its host entry, W lanes per ray as W
    threads: the tensor-core and cp.async code is CUDA only)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    out = tmp_path_factory.mktemp("leaf")
    return {w: bl.bind(cubuild.host_library("leaf", out, {"LEAF_LANES": w}))
            for w in bl.LANES}


@pytest.mark.parametrize("lanes", bl.LANES)
@pytest.mark.parametrize("mode", ["vpu", "vpu_rec", "vpu_cond", "vpu_dma",
                                  "vpu_while"])
@pytest.mark.parametrize("k2", [16, 64])
def test_torch_leaf_kernel_source_matches_plain(host_leaf, mode, k2, lanes):
    """The kernel's scalar modes (their arithmetic, the lane split with
    its (t, least slot) group reduction and the loop-carried updates,
    through the host build) equal the plain version bit for bit at every
    lane count the kernel can be built for."""
    tabs = bl.kernel_tables(bl.make_inputs(k2, seed=3), "cpu")
    n_iter = 40
    out = np.empty(128, np.float32)
    lib = host_leaf[lanes]
    rc = lib.leaf_host(bl.MODES.index(mode), tabs["tri_rows"].data_ptr(),
                       tabs["rays"].data_ptr(), tabs["hbm_rows"].data_ptr(),
                       k2, bl.N_BLK, n_iter, out.ctypes.data)
    assert rc == 0
    want = bl.leaf_plain(mode, tabs, k2, n_iter).numpy()
    assert (want < 1e29).sum() > 5
    np.testing.assert_array_equal(out, want)
    # the host entry refuses the tensor-core modes
    assert lib.leaf_host(1, tabs["tri_rows"].data_ptr(),
                         tabs["rays"].data_ptr(), tabs["hbm_rows"].data_ptr(),
                         k2, bl.N_BLK, 1, out.ctypes.data) != 0


@pytest.mark.parametrize("mode", ["mxu_hi", "mxu_3x", "mxu_1x"])
def test_torch_leaf_mxu_staging_model(mode):
    """The tensor-core modes stage B in wgmma's core-matrix layout: a model
    of that staging (bench_leaf.stage_b), read back through the addresses
    of the kernel's descriptors (unstage_b), gives B exactly, so the
    product through it is bench_leaf._product's result bit for bit."""
    k2 = 128
    inp = bl.make_inputs(k2, seed=5)
    trib = torch.from_numpy(inp["trib"])
    flat = bl.stage_b(trib, mode)
    assert flat.shape == (16 * 4 * k2,)
    assert not torch.equal(flat, trib.reshape(-1))      # a real permutation
    back = bl.unstage_b(flat, mode, k2)
    assert torch.equal(back, trib)
    a = torch.from_numpy(np.random.default_rng(6).normal(
        size=(128, 16)).astype(np.float32))
    assert torch.equal(bl._mxu_q(mode, a, back), bl._mxu_q(mode, a, trib))


def test_torch_leaf_run_refuses_bad_input():
    tabs = bl.kernel_tables(bl.make_inputs(K2), "cpu")
    with pytest.raises(ValueError):
        bl.leaf_run("mxu_2x", tabs, K2, 1)


@pytest.mark.cuda
def test_torch_leaf_kernel_matches_plain_on_card():
    """On the card: every mode of csrc/leaf.cu against its plain version
    (vpu modes bit for bit in the build of every lane count, tensor-core
    modes within 1e-3 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tabs = bl.kernel_tables(bl.make_inputs(256), "cuda")
    for lanes in bl.LANES:
        lib = bl.build(lanes=lanes) if lanes != bl.DEFAULT_LANES else None
        for mode in bl.MODES:
            got = bl.leaf_run(mode, tabs, 256, 16, lib)
            ref = bl.leaf_plain(mode, tabs, 256, 16)
            torch.cuda.synchronize()
            assert bl.max_rel_err(got, ref) <= (
                1e-3 if mode.startswith("mxu") else 0.0), (mode, lanes)
