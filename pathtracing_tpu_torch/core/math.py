"""Vector math primitives (counterpart of pathtracing_tpu/core/math.py).

Everything operates on float32 tensors with a trailing 3-component axis, or
on (x, y, z) component triples of [N] tensors in the hot paths.  The guards
(`safe_*`) keep the same thresholds as the reference package so masked lanes
stay finite and results agree to float precision.
"""
from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
SHADOW_EPS = 1e-5  # reference AABB.hpp:6 `shadowEpsilon`
BIG_F32 = 3.0e38   # stand-in for +inf that survives arithmetic


# Elementwise transcendentals.  PyTorch's CPU kernels for these are not
# correctly rounded (its vectorized float32 sqrt differs from IEEE on ~0.7%
# of inputs).  On the CPU, sin / cos / atan2 go through the C library's
# float32 functions (native/libm_vec.cpp; the reference package's CPU code
# evaluates them the same way) and the others through float64 rounded
# once; on the GPU the float32 kernels are used as they are.  So the CPU
# numerics are the ones held to the reference package bit for bit where
# they can be; the GPU's are held to the port's own CPU render.
def _f64_on_cpu(fn):
    def op(*xs):
        if xs[0].device.type == "cpu":
            return fn(*(x.double() for x in xs)).float()
        return fn(*xs)
    op.__name__ = fn.__name__
    return op


def _libm_on_cpu(fn, name):
    fallback = _f64_on_cpu(fn)

    def op(*xs):
        if xs[0].device.type != "cpu":
            return fn(*xs)
        from ..native.loader import libm_vec
        lib = libm_vec()
        if lib is None:
            return fallback(*xs)
        xs = [x.to(torch.float32).contiguous()
              for x in torch.broadcast_tensors(*xs)]
        out = torch.empty_like(xs[0])
        getattr(lib, name)(*(x.data_ptr() for x in xs), out.data_ptr(),
                           out.numel())
        return out
    op.__name__ = fn.__name__
    return op


fsqrt = _f64_on_cpu(torch.sqrt)
fsin = _libm_on_cpu(torch.sin, "sinf_v")
fcos = _libm_on_cpu(torch.cos, "cosf_v")
fexp = _f64_on_cpu(torch.exp)
flog = _f64_on_cpu(torch.log)
facos = _f64_on_cpu(torch.arccos)
fatan2 = _libm_on_cpu(torch.atan2, "atan2f_v")


def fma(a, b, c):
    """a*b + c; on the CPU rounded once (through float64: the product is
    exact there), on the GPU one addcmul kernel.

    The reference package's jitted CPU code contracts some multiply-adds
    into fused ones (sphere quadratics, hit points, squared norms); the
    port rounds those spots alike on the CPU."""
    if a.device.type == "cpu":
        return (a.double() * b.double() + c.double()).float()
    return torch.addcmul(c, a, b)


def vdot(a, b):
    """Dot product over the trailing axis, keeps leading shape."""
    return torch.sum(a * b, dim=-1)


def vdot_k(a, b):
    """Dot product, keepdims on the trailing axis (for broadcasting)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def safe_sqrt(x):
    """sqrt that is 0 at and below 1e-24 (same threshold as the reference)."""
    pos = x > 1e-24
    return torch.where(pos, fsqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_normalize(v):
    """normalize(v) that passes vectors with |v|^2 <= 1e-12 through.
    |v|^2 accumulates x, y, z as fused multiply-adds, as the reference's
    jitted CPU reduction does (a one-ulp camera-ray difference otherwise
    turns a grazing sphere hit into a 1e-3 pixel difference)."""
    n2 = fma(v[..., 2:3], v[..., 2:3],
             fma(v[..., 1:2], v[..., 1:2], v[..., 0:1] * v[..., 0:1]))
    pos = n2 > 1e-12
    return torch.where(pos, v / fsqrt(torch.where(pos, n2, 1.0)), v)


def safe_denom(x, eps):
    """Sign-preserving denominator clamp: |result| >= eps, sign of x."""
    mag = torch.clamp(torch.abs(x), min=eps)
    return torch.where(x < 0, -mag, mag)


def _inv_guard(direction):
    """1 / direction with components of magnitude below 1e-32 replaced by
    +-1e-32 (the sign of the component): the slab tests' reciprocals."""
    small = torch.abs(direction) < 1e-32
    return 1.0 / torch.where(small, torch.where(direction < 0, -1e-32, 1e-32),
                             direction)


def cross(a, b):
    return torch.cross(a, b, dim=-1)


def offset_ray(p, n):
    """Integer-ULP ray-origin offset along the normal (Ray Tracing Gems
    ch.6): scale-invariant, a few ULPs at any magnitude."""
    of_i = (256.0 * n).to(torch.int32)
    p_i = p.view(torch.int32)
    p_adj = torch.where(p < 0.0, p_i - of_i, p_i + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0,
                       p + (1.0 / 65536.0) * n, p_adj)


def luminance(c):
    """Rec.709 luminance."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=c.dtype,
                     device=c.device)
    return vdot(c, w)


def sphere_uv(p):
    """Spherical UV from a direction."""
    p = safe_normalize(p)
    theta = facos(torch.clamp(p[..., 1], -1.0, 1.0))
    phi = fatan2(p[..., 2], p[..., 0])
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    return torch.stack([phi * (0.5 * INV_PI), theta * INV_PI], dim=-1)


def uv_to_direction(uv):
    """z in [-1,1] from u, azimuth from v (the infinite-light sampling
    parameterisation)."""
    z = 2.0 * uv[..., 0] - 1.0
    theta = 2.0 * math.pi * uv[..., 1]
    r = fsqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * fcos(theta), r * fsin(theta), z],
                       dim=-1)


def in_unit_disk(uv):
    """Polar disk sample."""
    r = fsqrt(uv[..., 0])
    theta = 2.0 * math.pi * uv[..., 1]
    return torch.stack([r * fcos(theta), r * fsin(theta)], dim=-1)


def linear_to_srgb(l):
    l = torch.clamp(l, 0.0, 1.0)
    return torch.where(l < 0.0031308, 12.92 * l,
                       1.055 * torch.clamp(l, min=1e-12) ** (1.0 / 2.4)
                       - 0.055)


# ---------------------------------------------------------------------------
# Component-triple geometry math
# ---------------------------------------------------------------------------

def unpack3(v):
    """[..., 3] -> (x, y, z) component tensors."""
    return v[..., 0], v[..., 1], v[..., 2]


def pack3(x, y, z):
    """(x, y, z) -> [..., 3]."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def sdot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def scross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def sdot_f(ax, ay, az, bx, by, bz):
    """sdot with the sums rounded as fused multiply-adds, in the order the
    reference package's compiled CPU code contracts them."""
    return fma(az, bz, fma(ax, bx, ay * by))


def scross_f(ax, ay, az, bx, by, bz):
    """scross with each difference of products rounded as one fused
    multiply-add (see sdot_f)."""
    return (fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
            fma(ax, by, -(ay * bx)))


def sbary_mix(bu, bv, bw, a0, a1, a2):
    """bu*a1 + bv*a2 + bw*a0 (barycentric interpolation of a vertex
    attribute), rounded as the reference's compiled CPU code does."""
    return fma(bw, a0, fma(bu, a1, bv * a2))


def ssafe_normalize(x, y, z):
    """Component form of safe_normalize (same 1e-12 guard)."""
    n2 = x * x + y * y + z * z
    pos = n2 > 1e-12
    inv = torch.where(pos, 1.0 / fsqrt(torch.where(pos, n2, 1.0)), 1.0)
    return x * inv, y * inv, z * inv


def snormalize(x, y, z, eps: float = 1e-18):
    """Component form of normalize(v, eps)."""
    n2 = torch.clamp(x * x + y * y + z * z, min=eps)
    inv = 1.0 / fsqrt(n2)
    return x * inv, y * inv, z * inv


def sreflect(ix, iy, iz, nx, ny, nz):
    """Component form of reflect (GLM convention)."""
    d2 = 2.0 * sdot(nx, ny, nz, ix, iy, iz)
    return ix - d2 * nx, iy - d2 * ny, iz - d2 * nz


def srefract(ix, iy, iz, nx, ny, nz, eta):
    """Component form of refract; zero vector on total internal reflection."""
    cosi = sdot(nx, ny, nz, ix, iy, iz)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    c = eta * cosi + safe_sqrt(k)
    ok = k >= 0.0
    return (torch.where(ok, eta * ix - c * nx, 0.0),
            torch.where(ok, eta * iy - c * ny, 0.0),
            torch.where(ok, eta * iz - c * nz, 0.0))


def sonb_from_normal(nx, ny, nz):
    """Orthonormal basis around n: returns (t, b) triples; up = (0,1,0)
    when |n.x| > 0.9999 else (1,0,0)."""
    big_x = torch.abs(nx) > 0.9999
    ux = torch.where(big_x, 0.0, 1.0)
    uy = torch.where(big_x, 1.0, 0.0)
    bx, by, bz = scross(nx, ny, nz, ux, uy, torch.zeros_like(ux))
    bx, by, bz = ssafe_normalize(bx, by, bz)
    tx, ty, tz = scross(bx, by, bz, nx, ny, nz)
    return (tx, ty, tz), (bx, by, bz)


def sto_local(t, b, n, vx, vy, vz):
    """World -> frame: t/b/n are component triples."""
    return (sdot(vx, vy, vz, *t), sdot(vx, vy, vz, *b),
            sdot(vx, vy, vz, *n))


def sto_world(t, b, n, lx, ly, lz):
    """Frame -> world: t/b/n are component triples."""
    return (lx * t[0] + ly * b[0] + lz * n[0],
            lx * t[1] + ly * b[1] + lz * n[1],
            lx * t[2] + ly * b[2] + lz * n[2])
