"""Micro-benchmark of the leaf test: scalar Moller-Trumbore against the
determinant form on the tensor cores (counterpart of
tools/bench_mxu_leaf.py, the JAX package's K4).

One block of 128 rays loops n_iter leaf tests of K2 triangles over tables
resident in shared memory (no traversal), in the eight modes of
csrc/leaf.cu: vpu, mxu_hi (3xTF32), mxu_3x (bf16x3), mxu_1x (one bf16
pass), vpu_rec, vpu_cond, vpu_dma (blocks streamed with cp.async) and
vpu_while (the 16-child selection loop).  The inputs are the JAX tool's
(`make_inputs`, the same seed and construction).  `leaf_run` launches the
kernel on CUDA tensors and runs the plain PyTorch version of the mode on
CPU tensors; `leaf_plain` is that plain version on any device (the
kernel's oracle on the card).

Usage (on the card): python -m pathtracing_tpu_torch.tools.bench_leaf [k2] [n_iter]
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..accel import cubuild
from ..core.math import BIG_F32

MODES = ("vpu", "mxu_hi", "mxu_3x", "mxu_1x", "vpu_rec", "vpu_cond",
         "vpu_dma", "vpu_while")
N_BLK = 512          # blocks of the streamed table (vpu_dma / vpu_while)
WHILE_G = 16         # children per vpu_while visit


def make_inputs(k2: int = 256, seed: int = 0) -> dict:
    """The JAX tool's tables (numpy, float32): tri [16, K2] (v0, e1, e2
    rows), trib [16, 4*K2] (the determinant form's B), rays [8, 128] (ox oy
    oz dx dy dz t_max), tri_hbm [16, 512*K2] (tri tiled with noise)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (k2, 3, 3)).astype(np.float32)
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    tri = np.zeros((16, k2), np.float32)
    tri[0:3] = v0.T
    tri[3:6] = e1.T
    tri[6:9] = e2.T
    n = np.cross(e1, e2)
    trib = np.zeros((16, 4 * k2), np.float32)
    trib[0:3, 0 * k2:1 * k2] = -n.T                      # det: d rows
    trib[3:6, 1 * k2:2 * k2] = n.T                       # tdet: o rows
    trib[9, 1 * k2:2 * k2] = -(v0 * n).sum(1)            # tdet: const
    trib[0:3, 2 * k2:3 * k2] = np.cross(v0, e2).T        # udet: d rows
    trib[6:9, 2 * k2:3 * k2] = e2.T                      # udet: oxd rows
    trib[0:3, 3 * k2:4 * k2] = np.cross(e1, v0).T        # vdet: d rows
    trib[6:9, 3 * k2:4 * k2] = -e1.T                     # vdet: oxd rows
    rays = np.zeros((8, 128), np.float32)
    o = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays[0:3] = o.T
    rays[3:6] = d.T
    rays[6] = 1e30
    tri_hbm = np.tile(tri[:, None, :], (1, N_BLK, 1)).reshape(16, -1)
    tri_hbm += rng.normal(0, 1e-3, tri_hbm.shape).astype(np.float32)
    return dict(tri=tri, trib=trib, rays=rays, tri_hbm=tri_hbm)


def kernel_tables(inputs: dict, device) -> dict:
    """The inputs as the kernel reads them, on `device`: tri_rows [K2, 12]
    and hbm_rows [512*K2, 12] (one row per triangle: v0, e1, e2, then three
    unused floats), trib [16, 4*K2] and rays [8, 128] as they are."""
    def rows(t16):
        return torch.from_numpy(np.ascontiguousarray(t16[:12].T)).to(device)
    return dict(tri_rows=rows(inputs["tri"]), hbm_rows=rows(inputs["tri_hbm"]),
                trib=torch.from_numpy(inputs["trib"]).to(device),
                rays=torch.from_numpy(inputs["rays"]).to(device))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _mt(rows, o, d, bound):
    """[128, K] Moller-Trumbore t (BIG_F32 where not accepted) of every ray
    against rows [K, 12], gated t < bound [128]: the kernel's arithmetic."""
    from ..accel.trace2 import _moller_trumbore
    t, _, _, _ = _moller_trumbore(o, d, rows[None].expand(o.shape[0], -1, -1),
                                  bound)
    return t


def _record(best, blk, t, blk0):
    tb, kb = torch.min(t, dim=1)                 # first minimum
    better = tb < best
    return torch.where(better, tb, best), torch.where(better, blk0 + kb, blk)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _product(a, b):
    """a [128, 16] x b [16, N] as sixteen rank-1 updates in float32 (k in
    order); no library product."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1, :]
    return acc


def _mxu_q(mode, a, b):
    if mode == "mxu_hi":
        return _product(a, b)
    if mode == "mxu_1x":        # one bf16 pass: operands rounded as the TPU
        return _product(_bf16(a), _bf16(b))
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return _product(ah, bh) + _product(ah, bl) + _product(al, bh)


def leaf_plain(mode: str, tabs: dict, k2: int, n_iter: int):
    """The mode's function in plain PyTorch (tabs: kernel_tables) ->
    best t [128]."""
    rays = tabs["rays"]
    o, d, best = rays[0:3].T, rays[3:6].T, rays[6].clone()
    dev = rays.device
    blk = torch.zeros((128,), dtype=torch.int64, device=dev)
    tri = tabs["tri_rows"]
    hbm = tabs["hbm_rows"].view(N_BLK, k2, 12)
    if mode.startswith("mxu"):
        ox, oy, oz = o.unbind(1)
        dx, dy, dz = d.unbind(1)
        one = torch.ones_like(ox)
        zero = torch.zeros_like(ox)
        a = torch.stack([dx, dy, dz, ox, oy, oz, oy * dz - oz * dy,
                         oz * dx - ox * dz, ox * dy - oy * dx, one]
                        + [zero] * 6, 1)
        q = _mxu_q(mode, a, tabs["trib"])
        det, tdet = q[:, :k2], q[:, k2:2 * k2]
        udet, vdet = q[:, 2 * k2:3 * k2], q[:, 3 * k2:]
        near0 = torch.abs(det) < 1e-9
        inv_det = 1.0 / torch.where(near0, 1.0, det)
        t, u, v = tdet * inv_det, udet * inv_det, vdet * inv_det
        for _ in range(n_iter):
            ok = (~near0 & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                  & (t >= 1e-4) & (t < best[:, None]))
            tb = torch.where(ok, t, BIG_F32).amin(1)
            best = torch.minimum(best, tb + 1e-7)
        return best
    if mode == "vpu":
        for _ in range(n_iter):
            best = torch.minimum(best, _mt(tri, o, d, best).amin(1) + 1e-7)
        return best
    if mode in ("vpu_rec", "vpu_cond"):
        for i in range(n_iter):
            best, blk = _record(best, blk, _mt(tri, o, d, best + 1e-7), i)
        return best
    if mode == "vpu_dma":
        for i in range(n_iter):
            best, blk = _record(best, blk,
                                _mt(hbm[i % N_BLK], o, d, best + 1e-7), i)
        return best
    if mode == "vpu_while":
        for v in range(n_iter // WHILE_G):
            for g in range(WHILE_G):
                best, blk = _record(best, blk, _mt(
                    hbm[(v * WHILE_G + g) % N_BLK], o, d, best + 1e-7), g)
        return best
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def bind(lib):
    """Declare the C signatures on a loaded library (leaf_launch in the
    CUDA build, leaf_host in cubuild.host_library's build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "leaf_launch"):
        lib.leaf_launch.restype = I
        lib.leaf_launch.argtypes = [I, P, P, P, P, I, I, I, I, P, P]
    else:
        lib.leaf_host.restype = I
        lib.leaf_host.argtypes = [I, P, P, P, I, I, I, P]
    return lib


def build_kernel() -> float:
    """Compile csrc/leaf.cu (if not built yet) and load it."""
    global _lib
    if _lib is not None:
        return 0.0
    _lib = bind(cubuild.load("leaf"))
    return cubuild.BUILD_SECONDS["leaf"]


def leaf_run(mode: str, tabs: dict, k2: int, n_iter: int):
    """Best t [128] of `mode` (tabs: kernel_tables): the kernel on CUDA
    tensors (one block of 128 threads, on the current stream), the plain
    version on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    rays = tabs["rays"]
    if not rays.is_cuda:
        return leaf_plain(mode, tabs, k2, n_iter)
    build_kernel()
    dev = rays.device
    shapes = dict(tri_rows=(k2, 12), hbm_rows=(N_BLK * k2, 12),
                  trib=(16, 4 * k2), rays=(8, 128))
    for name, shape in shapes.items():
        x = tabs[name]
        if (x.device != dev or x.dtype != torch.float32
                or not x.is_contiguous() or tuple(x.shape) != shape):
            raise ValueError(f"leaf: {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}")
    out = torch.empty((128,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.leaf_launch(MODES.index(mode), tabs["tri_rows"].data_ptr(),
                          tabs["trib"].data_ptr(), rays.data_ptr(),
                          tabs["hbm_rows"].data_ptr(), k2, N_BLK, n_iter, 0,
                          out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"leaf kernel launch failed (cudaError {rc})")
    leaf_run.launches_by_mode[mode] += 1
    return out


leaf_run.launches_by_mode = {m: 0 for m in MODES}


def reset_launches():
    for m in MODES:
        leaf_run.launches_by_mode[m] = 0


def max_rel_err(out, ref) -> float:
    """The JAX tool's error: max |out - ref| / max(|ref|, 1e-3)."""
    out = out.double()
    ref = ref.double()
    return float((torch.abs(out - ref)
                  / torch.clamp(torch.abs(ref), min=1e-3)).max())


def time_mode(mode, tabs, k2, n_iter, reps=3):
    """Seconds per kernel run (CUDA events over `reps` runs after one
    warm-up run)."""
    leaf_run(mode, tabs, k2, n_iter)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = leaf_run(mode, tabs, k2, n_iter)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps, out


def bench(k2: int = 256, n_iter: int = 2000, printer=print) -> dict:
    """The JAX tool's measurement on the card: the null-kernel baseline
    (vpu, n_iter=0), then every mode's time, its microseconds per child
    test above the baseline and its max relative error against vpu.
    Returns {mode: dict(ms, us_per_child, err_vs_vpu, out)}."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_leaf measures the CUDA kernel: no GPU")
    tabs = kernel_tables(make_inputs(k2), "cuda")
    printer(f"k2={k2} n_iter={n_iter} backend=cuda "
            f"({torch.cuda.get_device_name(0)})")
    base, _ = time_mode("vpu", tabs, k2, 0)
    printer(f"null-kernel baseline {base * 1e3:8.2f} ms")
    res, ref = {}, None
    for mode in MODES:
        dt, out = time_mode(mode, tabs, k2, n_iter)
        us = (dt - base) / n_iter * 1e6
        if ref is None:
            ref, err = out, 0.0
        else:
            err = max_rel_err(out, ref)
        printer(f"{mode:9s} {dt * 1e3:8.2f} ms total  {us:7.3f} us/child  "
                f"max rel err vs vpu {err:.2e}")
        res[mode] = dict(ms=dt * 1e3, us_per_child=us, err_vs_vpu=err,
                         out=out)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k2 = int(argv[0]) if len(argv) > 0 else 256
    n_iter = int(argv[1]) if len(argv) > 1 else 2000
    bench(k2, n_iter, printer=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
