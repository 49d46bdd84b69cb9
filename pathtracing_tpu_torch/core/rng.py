"""Counter-based RNG and samplers (counterpart of pathtracing_tpu/core/rng.py).

Every random number is a pure function of (pixel, sample_index, dimension,
seed), bit-equal to the reference package.  PyTorch has little uint32
arithmetic, so values are carried as int64 tensors holding a uint32 in the
low 32 bits, and every multiply and left shift is masked back to 32 bits.
Multiplies by a 32-bit constant are split into two 16-bit halves so no
intermediate product leaves the signed 64-bit range.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.profile import count

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
    like = next((a for a in args if isinstance(a, torch.Tensor)), None)
    h = _u32(0x9E3779B9, like)
    for a in args:
        h = mix32(h ^ _u32(a, like) ^ ((h << 6) & _M32) ^ (h >> 2))
    return h


def uniform_from_u32(h):
    """u32 -> float32 in [0, 1): the top 24 bits."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def hash_float(*args):
    return uniform_from_u32(hash_u32(*args))


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
        hash_u32(px, py, sample_idx, dim, lane, cfg.seed ^ 0x5BF03635))


def sample_1d(cfg: SamplerConfig, px, py, sample_idx, dim):
    """One stratified 1D sample per lane."""
    if cfg.kind == "uniform":
        return _jitter(cfg, px, py, sample_idx, dim, 0)
    seed = hash_u32(px, py, dim, cfg.seed)
    stratum = permutation_element(sample_idx, cfg.spp, seed)
    u = _jitter(cfg, px, py, sample_idx, dim, 0)
    return (stratum.to(torch.float32) + u) / float(cfg.spp)


def sample_2d(cfg: SamplerConfig, px, py, sample_idx, dim):
    """One stratum over the 2D grid, split into (sx, sy) + per-axis jitter."""
    if cfg.kind == "uniform":
        return torch.stack([
            _jitter(cfg, px, py, sample_idx, dim, 0),
            _jitter(cfg, px, py, sample_idx, dim, 1)], dim=-1)
    seed = hash_u32(px, py, dim, cfg.seed)
    stratum = permutation_element(sample_idx, cfg.spp, seed)
    sx = (stratum % cfg.x_samples).to(torch.float32)
    sy = (stratum // cfg.x_samples).to(torch.float32)
    dx = _jitter(cfg, px, py, sample_idx, dim, 0)
    dy = _jitter(cfg, px, py, sample_idx, dim, 1)
    return torch.stack([(sx + dx) / float(cfg.x_samples),
                        (sy + dy) / float(cfg.y_samples)], dim=-1)
