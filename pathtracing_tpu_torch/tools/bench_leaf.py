"""Micro-benchmark of the leaf test: scalar Moller-Trumbore against the
determinant form on the tensor cores (counterpart of
tools/bench_mxu_leaf.py, the JAX package's K4).

One block (one SM) loops n_iter leaf tests of K2 triangles for 128 rays
over tables resident in shared memory (no traversal), in the eight modes
of csrc/leaf.cu: vpu, mxu_hi (3xTF32), mxu_3x (bf16x3), mxu_1x (one bf16
pass), vpu_rec, vpu_cond, vpu_dma (blocks streamed with cp.async) and
vpu_while (the 16-child selection loop).  The scalar modes run
DEFAULT_LANES lanes per ray, the tensor-core modes four warpgroups
issuing wgmma on chunks of 16 triangles; `build` makes the other builds
the A/Bs compare (lanes per ray, warpgroups x chunk width).  The inputs
are the JAX
tool's (`make_inputs`, the same seed and construction).  `leaf_run`
launches the kernel on CUDA tensors and runs the plain PyTorch version of
the mode on CPU tensors; `leaf_plain` is that plain version on any device
(the kernel's oracle on the card).

Usage (on the card):
    python -m pathtracing_tpu_torch.tools.bench_leaf [k2] [n_iter] \
        [--lanes 8 4] [--rounds 7] [--mxu-builds 4x16 4x32 2x16]
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys

import numpy as np
import torch

from ..accel import cubuild
from ..core.math import BIG_F32
from ..utils import profile

MODES = ("vpu", "mxu_hi", "mxu_3x", "mxu_1x", "vpu_rec", "vpu_cond",
         "vpu_dma", "vpu_while")
N_BLK = 512          # blocks of the streamed table (vpu_dma / vpu_while)
WHILE_G = 16         # children per vpu_while visit
LANES = (1, 2, 4, 8)     # lanes per ray the scalar modes can be built for
DEFAULT_LANES = 8        # leaf.cu's LEAF_LANES, chosen by `bench`'s A/B
MXU_K2 = 32              # the tensor-core modes take K2 in multiples of this


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


# The tensor-core modes' shared-memory layout of B (csrc/leaf.cu,
# staged_column, stage_b and issue_chunk), in elements (4 bytes for
# mxu_hi's tf32, 2 for bf16): column n = q * K2 + m (quantity q of triangle
# m) goes to staged column s = 4 * N * (m // N) + 32 * (m % N // 8)
# + 8 * q + m % 8 (per chunk of N = MXU_N triangles, the four quantities
# of 8 triangles in four consecutive 8-column groups), and column s, K
# chunk c
# (16 bytes: EPC elements) to
#   (s // 8) * 8 * 16 + c * 8 * EPC + (s % 8) * EPC,
# 8 columns of one chunk forming a core matrix; the wgmma of chunk ch and
# K step ks covers 4 N staged columns from (ch * 4 N // 8) * 128
# + ks * 2 * 8 * EPC and walks K chunks at LBO = 8 * EPC, 8-column groups
# at SBO = 128 elements.
MXU_N = 16               # leaf.cu's LEAF_MXU_N: triangles per chunk


def _epc(mode):
    return 4 if mode == "mxu_hi" else 8


def staged_column(n, k2):
    """leaf.cu's staged_column: where B's column n is staged."""
    m = n % k2
    return 4 * MXU_N * (m // MXU_N) + 32 * (m % MXU_N // 8) + 8 * (n // k2) \
        + m % 8


def stage_b(trib, mode):
    """B [16, 4 K2] laid out as leaf.cu's stage_b lays it out (the values
    unrounded): a flat tensor of 16 x 4 K2 elements."""
    epc = _epc(mode)
    k, n = torch.meshgrid(torch.arange(16), torch.arange(trib.shape[1]),
                          indexing="ij")
    sc = staged_column(n, trib.shape[1] // 4)
    off = (sc // 8) * 128 + (k // epc) * 8 * epc + (sc % 8) * epc + k % epc
    flat = torch.empty(trib.numel(), dtype=trib.dtype)
    flat[off.reshape(-1)] = trib.reshape(-1)
    return flat


def unstage_b(flat, mode, k2):
    """B [16, 4 K2] read back from stage_b's layout through the addresses
    the kernel's wgmma descriptors give, chunk by chunk (the 4 MXU_N
    staged columns of MXU_N triangles, one K step of 8 tf32 or all 16
    bf16 at a time), each staged column put back where post_chunk reads
    it from:
    8-column group 4 b + q is quantity q of the chunk's triangles
    8 b ... 8 b + 7."""
    epc = _epc(mode)
    kstep = 8 if mode == "mxu_hi" else 16
    lbo, sbo = 8 * epc, 128
    out = torch.empty((16, 4 * k2), dtype=flat.dtype)
    kk, j = torch.meshgrid(torch.arange(kstep), torch.arange(4 * MXU_N),
                           indexing="ij")
    grp = j[0] // 8
    col = (grp % 4) * k2 + 8 * (grp // 4) + j[0] % 8    # q * k2 + triangle
    for ch in range(k2 // MXU_N):
        for ks in range(16 // kstep):
            start = (4 * MXU_N * ch // 8) * 128 + ks * 2 * 8 * epc
            addr = (start + (j // 8) * sbo + (j % 8) * epc
                    + (kk // epc) * lbo + kk % epc)
            out[ks * kstep:(ks + 1) * kstep, col + MXU_N * ch] = flat[addr]
    return out


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
    return profile.counters()["kernels.leaf_s"]


def build_defines(lanes=None, wgs=None, n=None) -> dict:
    """The -D flags of another build of csrc/leaf.cu: its scalar modes at
    `lanes` lanes per ray, its tensor-core modes on `wgs` warpgroups (2:
    one per 64 rays; 4: two per 64 rays, each half the triangles) and
    chunks of `n` triangles (the wgmma n: 16 or 32)."""
    names = ("LEAF_LANES", "LEAF_MXU_WGS", "LEAF_MXU_N")
    return {k: v for k, v in zip(names, (lanes, wgs, n)) if v is not None}


def build(lanes=None, wgs=None, n=None):
    """That build (compiled if not built yet), bound; None for the
    package's own."""
    d = build_defines(lanes, wgs, n)
    return bind(cubuild.load("leaf", d)) if d else None


def leaf_run(mode: str, tabs: dict, k2: int, n_iter: int, lib=None):
    """Best t [128] of `mode` (tabs: kernel_tables): the kernel on CUDA
    tensors (one block on the current stream; the tensor-core modes take
    K2 in multiples of MXU_K2; lib: another build, as `build` gives, not
    counted as a launch), the plain version on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    rays = tabs["rays"]
    if not rays.is_cuda:
        return leaf_plain(mode, tabs, k2, n_iter)
    if mode.startswith("mxu") and k2 % MXU_K2:
        raise ValueError(f"the {mode} kernel takes K2 in multiples of "
                         f"{MXU_K2}, got {k2}")
    if lib is None:
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
    rc = (lib or _lib).leaf_launch(MODES.index(mode),
                          tabs["tri_rows"].data_ptr(),
                          tabs["trib"].data_ptr(), rays.data_ptr(),
                          tabs["hbm_rows"].data_ptr(), k2, N_BLK, n_iter, 0,
                          out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"leaf kernel launch failed (cudaError {rc})")
    if lib is None:
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


def time_mode(mode, tabs, k2, n_iter, reps=3, lib=None):
    """Seconds per kernel run (CUDA events over `reps` runs after one
    warm-up run) and the last run's output."""
    leaf_run(mode, tabs, k2, n_iter, lib)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = leaf_run(mode, tabs, k2, n_iter, lib)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps, out


def bench(k2: int = 256, n_iter: int = 2000, rounds: int = 7,
          lanes=(DEFAULT_LANES,), printer=print) -> dict:
    """The JAX tool's measurement on the card, in `rounds` interleaved
    rounds (each round takes one time_mode sample of every mode, the
    scalar modes in the build of every lane count of `lanes`, in turn, so
    drift on the card falls on all alike): the null-kernel baseline (vpu,
    n_iter=0), then every mode's median time and spread ((max - min) /
    median), its microseconds per child test above the baseline and its
    max relative error against vpu.  Returns {mode: dict(ms, spread,
    us_per_child, err_vs_vpu, out, by_lanes)}: the scalar modes' numbers
    are at lanes[0]; by_lanes maps each lane count to (median ms,
    spread)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_leaf measures the CUDA kernel: no GPU")
    tabs = kernel_tables(make_inputs(k2), "cuda")
    printer(f"k2={k2} n_iter={n_iter} backend=cuda "
            f"({torch.cuda.get_device_name(0)}), {rounds} interleaved "
            f"rounds, scalar modes at lanes {tuple(lanes)}")
    libs = {w: build(lanes=w) if w != DEFAULT_LANES else None for w in lanes}
    runs = [("base", "vpu", lanes[0], 0)] + [
        (f"{m}@{w}" if not m.startswith("mxu") else m, m, w, n_iter)
        for m in MODES for w in (lanes if not m.startswith("mxu")
                                 else lanes[:1])]
    samples, outs = {}, {}
    for _ in range(rounds):
        for key, mode, w, n in runs:
            dt, outs[key] = time_mode(mode, tabs, k2, n, lib=libs[w])
            samples.setdefault(key, []).append(dt * 1e3)
    stat = {k: (statistics.median(v), (max(v) - min(v)) / statistics.median(v))
            for k, v in samples.items()}
    base = stat["base"][0]
    printer(f"null-kernel baseline {base:8.3f} ms")
    res = {}
    ref = outs[f"vpu@{lanes[0]}"]
    for mode in MODES:
        key = mode if mode.startswith("mxu") else f"{mode}@{lanes[0]}"
        ms, spread = stat[key]
        err = max_rel_err(outs[key], ref)
        us = (ms - base) / n_iter * 1e3
        by_lanes = {} if mode.startswith("mxu") else {
            w: stat[f"{mode}@{w}"] for w in lanes}
        ab = "".join(f"  W={w}: {m:.3f} ms ({s:.1%})"
                     for w, (m, s) in by_lanes.items()) if len(lanes) > 1 \
            else ""
        printer(f"{mode:9s} {ms:8.3f} ms total (spread {spread:.1%})  "
                f"{us:7.3f} us/child  max rel err vs vpu {err:.2e}{ab}")
        res[mode] = dict(ms=ms, spread=spread, us_per_child=us,
                         err_vs_vpu=err, out=outs[key], by_lanes=by_lanes)
    return res


def mxu_ab(builds, k2: int = 256, n_iter: int = 2000, rounds: int = 7,
           printer=print) -> dict:
    """A/B of the tensor-core modes' builds ((warpgroups, chunk width)
    pairs, `build`): each build's ptxas lines, each mode held to its
    plain version at n_iter=16 (the tolerances of chip_smoke.py), then
    every (build, mode) timed in `rounds` interleaved rounds.  Returns
    {(wgs, n, mode): (median ms, spread, max rel err)}."""
    tabs = kernel_tables(make_inputs(k2), "cuda")
    libs = {b: build(wgs=b[0], n=b[1]) for b in builds}
    tol = dict(mxu_hi=1e-4, mxu_3x=1e-3, mxu_1x=1e-3)
    errs = {}
    for b, lib in libs.items():
        name = cubuild.key("leaf", build_defines(wgs=b[0], n=b[1]))
        for fn, line in cubuild.kernel_resources(name):
            if "mxu" in fn:
                printer(f"[ptxas] wgs={b[0]} n={b[1]} {fn}: {line}")
        for mode in tol:
            ref = leaf_plain(mode, tabs, k2, 16)
            errs[b + (mode,)] = e = max_rel_err(
                leaf_run(mode, tabs, k2, 16, lib=lib), ref)
            if not e <= tol[mode]:
                raise RuntimeError(f"{mode} of build {b} disagrees with its "
                                   f"plain version ({e:.3e})")
    samples = {}
    for _ in range(rounds):
        for b, lib in libs.items():
            for mode in tol:
                samples.setdefault(b + (mode,), []).append(
                    time_mode(mode, tabs, k2, n_iter, lib=lib)[0] * 1e3)
    out = {}
    for k, v in samples.items():
        med = statistics.median(v)
        out[k] = (med, (max(v) - min(v)) / med, errs[k])
        printer(f"[mxu A/B] wgs={k[0]} n={k[1]} {k[2]}: {med:.3f} ms "
                f"(median of {rounds} interleaved rounds, spread "
                f"{(max(v) - min(v)) / med:.1%}), max rel err vs plain "
                f"{errs[k]:.3e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("k2", type=int, nargs="?", default=256)
    ap.add_argument("n_iter", type=int, nargs="?", default=2000)
    ap.add_argument("--lanes", type=int, nargs="+", default=[DEFAULT_LANES],
                    help="lanes per ray of the scalar modes' builds; the "
                    "first is reported, the others timed beside it (A/B)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--mxu-builds", nargs="*", default=[],
                    metavar="WGSxN", help="also A/B these builds of the "
                    "tensor-core modes (e.g. 2x32 4x16)")
    args = ap.parse_args(argv)
    out = lambda s: print(s, flush=True)    # noqa: E731
    bench(args.k2, args.n_iter, args.rounds, tuple(args.lanes), printer=out)
    if args.mxu_builds:
        mxu_ab([tuple(int(x) for x in b.split("x")) for b in args.mxu_builds],
               args.k2, args.n_iter, args.rounds, printer=out)


if __name__ == "__main__":
    main()
