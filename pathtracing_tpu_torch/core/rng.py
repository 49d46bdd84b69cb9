"""Counter-based RNG and samplers (counterpart of pathtracing_tpu/core/rng.py).

Every random number is a pure function of (pixel, sample_index, dimension,
seed), bit-equal to the reference package.  PyTorch has little uint32
arithmetic, so values are carried as int64 tensors holding a uint32 in the
low 32 bits, and every multiply and left shift is masked back to 32 bits.
Multiplies by a 32-bit constant are split into two 16-bit halves so no
intermediate product leaves the signed 64-bit range.

On CUDA tensors `hash_u32`, `hash_float`, `sample_1d` and `sample_2d` are
one launch each of the hand-written kernel csrc/sampler.cu (`launch`): the
same bits, with the integer keys passed as kernel arguments, so nothing is
copied to the card and the host never waits for it.  On CPU tensors they
are the plain PyTorch versions (`hash_u32_plain`, ...), which the tests
and chip_smoke.py hold the kernel to.
"""
from __future__ import annotations

import ctypes
import dataclasses
import operator

import torch

from ..utils.profile import count, set_count

_M32 = 0xFFFFFFFF


def _u32(x, like=None):
    """Coerce a Python int or an integer tensor to an int64 'uint32'.  An
    int goes to like's device: a copy the host waits for (a host sync)."""
    if isinstance(x, int):
        dev = like.device if like is not None else None
        if dev is not None:
            count("host_syncs")
        return torch.tensor(x & _M32, dtype=torch.int64, device=dev)
    return x.to(torch.int64) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x):
    """32-bit finalizer (lowbias32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(*args):
    """Hash a sequence of u32-coercible values into one u32 stream key."""
    if _on_card(args):
        return launch("hash_u32", args)
    return hash_u32_plain(*args)


def hash_u32_plain(*args):
    """hash_u32 in plain PyTorch."""
    like = next((a for a in args if isinstance(a, torch.Tensor)), None)
    h = _u32(0x9E3779B9, like)
    for a in args:
        h = mix32(h ^ _u32(a, like) ^ ((h << 6) & _M32) ^ (h >> 2))
    return h


def uniform_from_u32(h):
    """u32 -> float32 in [0, 1): the top 24 bits."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def hash_float(*args):
    """hash_u32 as a float32 in [0, 1) (uniform_from_u32)."""
    if _on_card(args):
        return launch("hash_float", args)
    return hash_float_plain(*args)


def hash_float_plain(*args):
    """hash_float in plain PyTorch."""
    return uniform_from_u32(hash_u32_plain(*args))


def permutation_element(i, l: int, p):
    """Kensler-style in-place permutation, vectorized over lanes."""
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w = w | (w >> s)
    i = _u32(i, p if isinstance(p, torch.Tensor) else None)
    p = _u32(p, i)
    i, p = torch.broadcast_tensors(i, p)

    def round_fn(i):
        i = i ^ p
        i = _mul32(i, 0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = _mul32(i, 0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (p >> 27))) & _M32
        i = _mul32(i, 0x6935FA69)
        i = i ^ ((i & w) >> 11)
        i = _mul32(i, 0x74DCB303)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0xC860A3DF)
        i = i & w
        i = i ^ (i >> 5)
        return i

    i = round_fn(i)
    if l & (l - 1) != 0:
        # non-power-of-two strata: re-round lanes still out of range
        # (one host sync per round)
        while bool((i >= l).any()):
            i = torch.where(i >= l, round_fn(i), i)
    return ((i + p) & _M32) % l


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler description.

    kind: "uniform" | "stratified"; spp = x_samples * y_samples strata;
    seed: global stream seed."""
    kind: str = "stratified"
    x_samples: int = 4
    y_samples: int = 4
    seed: int = 0

    @property
    def spp(self) -> int:
        return self.x_samples * self.y_samples


def _jitter(cfg: SamplerConfig, px, py, sample_idx, dim, lane):
    """In-stratum jitter, counter-based on all coordinates."""
    return uniform_from_u32(
        hash_u32_plain(px, py, sample_idx, dim, lane, cfg.seed ^ 0x5BF03635))


def sample_1d(cfg: SamplerConfig, px, py, sample_idx, dim):
    """One stratified 1D sample per lane."""
    keys = (px, py, sample_idx, dim)
    if _on_card(keys):
        return launch("sample_1d", keys, cfg)
    return sample_1d_plain(cfg, *keys)


def sample_1d_plain(cfg: SamplerConfig, px, py, sample_idx, dim):
    """sample_1d in plain PyTorch."""
    if cfg.kind == "uniform":
        return _jitter(cfg, px, py, sample_idx, dim, 0)
    seed = hash_u32_plain(px, py, dim, cfg.seed)
    stratum = permutation_element(sample_idx, cfg.spp, seed)
    u = _jitter(cfg, px, py, sample_idx, dim, 0)
    return (stratum.to(torch.float32) + u) / float(cfg.spp)


def sample_2d(cfg: SamplerConfig, px, py, sample_idx, dim):
    """One stratum over the 2D grid, split into (sx, sy) + per-axis jitter."""
    keys = (px, py, sample_idx, dim)
    if _on_card(keys):
        return launch("sample_2d", keys, cfg)
    return sample_2d_plain(cfg, *keys)


def sample_2d_plain(cfg: SamplerConfig, px, py, sample_idx, dim):
    """sample_2d in plain PyTorch."""
    if cfg.kind == "uniform":
        return torch.stack([
            _jitter(cfg, px, py, sample_idx, dim, 0),
            _jitter(cfg, px, py, sample_idx, dim, 1)], dim=-1)
    seed = hash_u32_plain(px, py, dim, cfg.seed)
    stratum = permutation_element(sample_idx, cfg.spp, seed)
    sx = (stratum % cfg.x_samples).to(torch.float32)
    sy = (stratum // cfg.x_samples).to(torch.float32)
    dx = _jitter(cfg, px, py, sample_idx, dim, 0)
    dy = _jitter(cfg, px, py, sample_idx, dim, 1)
    return torch.stack([(sx + dx) / float(cfg.x_samples),
                        (sy + dy) / float(cfg.y_samples)], dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernel: csrc/sampler.cu
# ---------------------------------------------------------------------------

_OPS = {"hash_u32": 0, "hash_float": 1, "sample_1d": 2, "sample_2d": 3}
MAX_KEYS = 8        # csrc/sampler.cu's SAMPLER_MAX_KEYS
_lib = None


def reset_launches():
    """Set the kernel's launch count, the profile counter "rng.launches",
    to 0."""
    set_count("rng.launches", 0)


def build_kernel():
    """Compile csrc/sampler.cu (if not built yet) and load it."""
    global _lib
    if _lib is None:
        from ..accel import cubuild
        _lib = bind(cubuild.load("sampler"))
    return _lib


def bind(lib):
    """Declare sampler_launch's C signature on a loaded library (the CUDA
    build, or cubuild.host_library's host build)."""
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.sampler_launch.restype = I
    lib.sampler_launch.argtypes = [I, ctypes.c_longlong, I, P, P, P, I, U, U,
                                   U, P, P]
    return lib


def _on_card(keys) -> bool:
    return any(isinstance(k, torch.Tensor) and k.is_cuda for k in keys)


def launch(op: str, keys, cfg: SamplerConfig | None = None, lib=None):
    """One launch of csrc/sampler.cu's `op` ("hash_u32", "hash_float",
    "sample_1d", "sample_2d") over `keys`: Python ints, 0-d tensors and 1-D
    tensors of one common length n (sample_*: px, py, sample index, dim,
    with cfg).  Returns what the plain function returns: [n] int64-held
    u32 (hash_u32), [n] float32, or [n, 2] float32 (sample_2d); () or [2]
    where no key is 1-D.  On the card it launches on the current stream,
    reads no device value, and is counted in the profile counter
    "rng.launches"; lib, a cubuild.host_library build, runs it on CPU
    tensors instead (the tests; not counted)."""
    if len(keys) > MAX_KEYS or (op.startswith("sample") and len(keys) != 4):
        raise ValueError(f"sampler: {op} of {len(keys)} keys")
    dev = torch.device("cpu") if lib is not None else next(
        k.device for k in keys if isinstance(k, torch.Tensor) and k.is_cuda)
    n, held = None, []
    ptrs, steps, vals = [0] * len(keys), [0] * len(keys), [0] * len(keys)
    for j, k in enumerate(keys):
        if not isinstance(k, torch.Tensor):
            vals[j] = operator.index(k) & _M32
            continue
        if k.ndim > 1:
            raise ValueError(f"sampler: key {j} has shape {tuple(k.shape)}; "
                             "a key is an int, a 0-d or an [n] tensor")
        if k.device != dev:
            if k.ndim == 0 and k.device.type == "cpu":
                vals[j] = int(k.to(torch.int64)) & _M32   # a host value
                continue
            raise ValueError(f"sampler: key {j} lies on {k.device}, the "
                             f"call on {dev}")
        if k.ndim == 1:
            if n is None:
                n = k.shape[0]
            elif k.shape[0] != n:
                raise ValueError(f"sampler: key {j} has {k.shape[0]} lanes, "
                                 f"an earlier key {n}")
        if k.dtype != torch.int64:
            k = k.to(torch.int64)
        held.append(k)
        ptrs[j], steps[j] = k.data_ptr(), (k.stride(0) if k.ndim else 0)
    stratified, xs, ys, seed = 0, 0, 0, 0
    if cfg is not None:
        stratified = int(cfg.kind != "uniform")
        xs, ys, seed = cfg.x_samples, cfg.y_samples, cfg.seed & _M32
        if stratified and not (xs > 0 and ys > 0 and xs * ys <= _M32):
            raise ValueError(f"sampler: {xs} x {ys} strata")
    shape = (() if n is None else (n,)) + ((2,) if op == "sample_2d" else ())
    out = torch.empty(shape, device=dev, dtype=torch.int64
                      if op == "hash_u32" else torch.float32)
    if n == 0:
        return out
    stream = None if lib is not None else \
        torch.cuda.current_stream(dev).cuda_stream
    m = len(keys)
    rc = (lib or build_kernel()).sampler_launch(
        _OPS[op], 1 if n is None else n, m, (ctypes.c_longlong * m)(*ptrs),
        (ctypes.c_longlong * m)(*steps), (ctypes.c_uint * m)(*vals),
        stratified, xs, ys, seed, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sampler kernel launch failed (cudaError {rc})")
    if lib is None:
        count("rng.launches")
    return out
