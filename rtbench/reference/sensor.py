"""The camera and the film, worked out from the scene description alone.

Written for the benchmark in NumPy float64, from the formulas, with no
code of the port and none of the frozen copy in snap/:

- the sampler: the stratified sampler's counter-based random numbers.
  Every number is a pure function of (pixel, sample index, dimension,
  seed): a hash chain of the lowbias32 integer finalizer (Wellons), a
  Kensler permutation of the pixel's strata ("Correlated Multi-Jittered
  Sampling", Pixar 2013), and the top 24 bits of a hash as the in-stratum
  jitter.  These are the sampler's stated constants and stream layout
  (dimension 0: the pixel jitter; 2: the shutter; 3: the lens), not a
  choice of the reference;
- the camera: a thin-lens camera from the description's look-from,
  look-at, vertical-up (0, 1, 0), horizontal field of view, resolution,
  focus angle and distance;
- the film: the Mitchell-Netravali filter (B = C = 1/3, radius 1.5
  pixels) splatted over the taps whose centres lie within the pixel
  radius, normalised by its integral (radius_x * radius_y / 4), summed in
  float64 (torch's index_add_, on the card when there is one).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = np.uint64(0xFFFFFFFF)
FILTER_RADIUS = (1.5, 1.5)
MITCHELL_B = MITCHELL_C = 1.0 / 3.0


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------

def _u(x):
    return np.asarray(x, dtype=np.int64).astype(np.uint64) & M32


def lowbias32(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & M32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & M32
    return x ^ (x >> np.uint64(16))


def chain(*args):
    """The stream key of a sequence of 32-bit words."""
    h = np.uint64(0x9E3779B9)
    for a in args:
        h = lowbias32(h ^ _u(a) ^ ((h << np.uint64(6)) & M32)
                      ^ (h >> np.uint64(2)))
    return h


def unit(h):
    """A 32-bit hash as a float in [0, 1): its top 24 bits."""
    return (h >> np.uint64(8)).astype(np.float64) * 2.0 ** -24


def kensler(i, n, p):
    """Element i of the permutation of 0 .. n-1 keyed by p."""
    w = n - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    w = np.uint64(w)
    i, p = np.broadcast_arrays(_u(i), _u(p))

    def rnd(i):
        def mul(x, c):
            return (x * np.uint64(c)) & M32

        def sh(x, k):
            return x >> np.uint64(k)
        i = mul(i ^ p, 0xE170893D)
        i = i ^ sh(p, 16)
        i = i ^ sh(i & w, 4)
        i = i ^ sh(p, 8)
        i = mul(i, 0x0929EB3F)
        i = i ^ sh(p, 23)
        i = i ^ sh(i & w, 1)
        i = (i * (np.uint64(1) | sh(p, 27))) & M32
        i = mul(i, 0x6935FA69)
        i = i ^ sh(i & w, 11)
        i = mul(i, 0x74DCB303)
        i = i ^ sh(i & w, 2)
        i = mul(i, 0x9E501CC3)
        i = i ^ sh(i & w, 2)
        i = mul(i, 0xC860A3DF)
        i = i & w
        return i ^ sh(i, 5)

    i = rnd(i)
    while (i >= np.uint64(n)).any():
        i = np.where(i >= np.uint64(n), rnd(i), i)
    return ((i + p) & M32) % np.uint64(n)


def sample2(sampler, px, py, sidx, dim):
    """The stratified sampler's 2D sample [N, 2] of dimension dim."""
    xs, ys = int(sampler["x_samples"]), int(sampler["y_samples"])
    seed = int(sampler["seed"])
    salt = seed ^ 0x5BF03635
    jx = unit(chain(px, py, sidx, dim, 0, salt))
    jy = unit(chain(px, py, sidx, dim, 1, salt))
    if sampler["kind"] == "uniform":
        return np.stack([jx, jy], -1)
    stratum = kensler(sidx, xs * ys, chain(px, py, dim, seed))
    sx = (stratum % np.uint64(xs)).astype(np.float64)
    sy = (stratum // np.uint64(xs)).astype(np.float64)
    return np.stack([(sx + jx) / xs, (sy + jy) / ys], -1)


def film_position(sampler, px, py, sidx):
    """The continuous film position [N, 2] of each (pixel, sample)."""
    return np.stack([px, py], -1).astype(np.float64) \
        + sample2(sampler, px, py, sidx, 0)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

def camera_of(desc):
    """The set_camera call of a scene description, as keyword arguments."""
    for name, args, kwargs in desc.calls:
        if name == "set_camera":
            names = ("look_from", "look_at", "fov", "resolution",
                     "focus_angle", "focus_distance", "shutter", "medium")
            return dict(zip(names, args), **kwargs)
    raise ValueError("the description sets no camera")


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def camera_rays(cam, sampler, px, py, sidx, rnd=None):
    """Origin and direction [N, 3] of each (pixel, sample)'s camera ray.
    rnd: a rounding applied to the basis and the results (the control)."""
    rnd = rnd or (lambda x: x)
    eye = np.asarray(cam["look_from"], np.float64)
    w = _normalize(eye - np.asarray(cam["look_at"], np.float64))
    u = _normalize(np.cross([0.0, 1.0, 0.0], w))
    v = np.cross(w, u)
    res_x, res_y = cam["resolution"]
    half_w = math.tan(float(cam["fov"]) / 2.0)
    half_h = half_w * res_y / res_x
    eye, u, v, w = (rnd(x) for x in (eye, u, v, w))
    p = film_position(sampler, px, py, sidx)
    a = (2.0 * p[:, 0] / res_x - 1.0) * half_w
    b = (2.0 * p[:, 1] / res_y - 1.0) * half_h
    d = _normalize(-w + a[:, None] * u + b[:, None] * v)
    o = np.broadcast_to(eye, d.shape)
    fd = float(cam.get("focus_distance", 0.0))
    radius = fd * math.tan(float(cam.get("focus_angle", 0.0)) / 2.0)
    if fd != 0.0 and radius != 0.0:
        lens = sample2(sampler, px, py, sidx, 3)
        r, th = np.sqrt(lens[:, 0]), 2.0 * math.pi * lens[:, 1]
        off = radius * ((r * np.cos(th))[:, None] * u
                        + (r * np.sin(th))[:, None] * v)
        d = _normalize(d * fd - off)
        o = o + off
    return rnd(o), rnd(d)


# ---------------------------------------------------------------------------
# Film
# ---------------------------------------------------------------------------

def mitchell(x, b=MITCHELL_B, c=MITCHELL_C):
    """The Mitchell-Netravali cubic on [-2, 2] (integral 1)."""
    x = np.abs(x)
    near = ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x ** 2
            + (6 - 2 * b)) / 6.0
    far = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
           + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


class Film:
    """Filter-weighted sums of colour and weight, [H*W, 4] float64 on
    `device` (summed there by index_add_)."""

    def __init__(self, resolution, device="cpu"):
        self.w, self.h = resolution
        self.acc = torch.zeros((self.h * self.w, 4), dtype=torch.float64,
                               device=device)

    @property
    def rgb(self):
        return self.acc[:, :3]

    @property
    def weight(self):
        return self.acc[:, 3]

    def splat(self, p, color):
        """Add colour [N, 3] at film positions p [N, 2] (NumPy)."""
        rx, ry = FILTER_RADIUS
        norm = rx * ry / 4.0
        kx, ky = (int(math.ceil(r - 0.5)) for r in FILTER_RADIUS)
        base = np.floor(p).astype(np.int64)
        dev = self.acc.device
        val = torch.cat([torch.as_tensor(color, dtype=torch.float64),
                         torch.ones((p.shape[0], 1), dtype=torch.float64)],
                        1).to(dev)
        for dy in range(-ky, ky + 1):
            for dx in range(-kx, kx + 1):
                tx, ty = base[:, 0] + dx, base[:, 1] + dy
                inb = (tx >= 0) & (tx < self.w) & (ty >= 0) & (ty < self.h)
                # the filter at the tap's centre, seen from the sample
                fw = (mitchell(2.0 * (tx + 0.5 - p[:, 0]) / rx)
                      * mitchell(2.0 * (ty + 0.5 - p[:, 1]) / ry)) / norm
                keep = torch.as_tensor(np.nonzero(inb)[0], device=dev)
                idx = torch.as_tensor((ty * self.w + tx)[inb], device=dev)
                fw = torch.as_tensor(fw[inb], device=dev)
                self.acc.index_add_(0, idx, val[keep] * fw[:, None])
