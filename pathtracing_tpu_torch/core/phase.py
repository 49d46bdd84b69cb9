"""Henyey-Greenstein phase function (counterpart of
pathtracing_tpu/core/phase.py)."""
from __future__ import annotations

import math

import torch

from .math import (INV_PI, fsqrt, fsin, fcos, vdot, safe_normalize,
                   sonb_from_normal, sto_world)


def phase_hg(cos_theta, g):
    """The HG phase value at cos_theta for asymmetry g."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    denom = torch.clamp(denom, min=1e-8)
    return 0.25 * INV_PI * (1.0 - g * g) / (denom * fsqrt(denom))


def hg_pdf(w_in, w_out, g):
    """pdf(w_in -> w_out) = phase_hg(dot(w_in, w_out), g)."""
    return phase_hg(vdot(w_in, w_out), g)


def hg_sample(w_in, g, uv):
    """Sample an outgoing direction around the incoming one (local +z is
    w_in); returns (w_out, pdf).  The direction is detached (detached
    sampling); the pdf, the phase value, stays differentiable in g."""
    u0, u1 = uv[..., 0], uv[..., 1]
    iso = torch.abs(g) < 1e-3
    cos_iso = 1.0 - 2.0 * u0
    g_safe = torch.where(iso, 0.5, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u0)
    cos_aniso = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(iso, cos_iso, cos_aniso)
    sin_theta = fsqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u1
    lx, ly = sin_theta * fcos(phi), sin_theta * fsin(phi)
    n = w_in.unbind(-1)
    t, b = sonb_from_normal(*n)
    w_out = safe_normalize(torch.stack(sto_world(t, b, n, lx, ly, cos_theta),
                                       -1))
    return w_out.detach(), phase_hg(cos_theta.detach(), g)
