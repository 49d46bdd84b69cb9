"""Homogeneous participating media (counterpart of
pathtracing_tpu/core/medium.py).

Media live in the scene's med_* tables; lanes carry a medium id (-1 =
vacuum).  The functions are vectorized over lanes and take the gathered
per-lane parameters.
"""
from __future__ import annotations

import torch

from .math import fexp, flog

_F32_MAX = float(torch.finfo(torch.float32).max)


def medium_tr(sigma_t, t):
    """Transmittance exp(-sigma_t * t): sigma_t [..., 3], t [...]."""
    t = torch.clamp(t, max=_F32_MAX)
    return fexp(-sigma_t * t[..., None])


def medium_sample(sigma_t, sigma_s, t_max, u_channel, u_dist):
    """Distance sampling with one-sample MIS over the RGB channels.

    Returns (scattered, t_scatter, weight):
      scattered  True where a real scattering event falls before t_max;
      t_scatter  the sampled distance, min(dist, t_max);
      weight     the throughput factor, tr * sigma_s / pdf (scatter) or
                 tr / pdf (passed through).
    The sampling decisions (channel, distance) are detached; the weight
    stays differentiable in sigma_t and sigma_s."""
    u_channel = u_channel.detach()
    u_dist = u_dist.detach()
    channel = torch.clamp((u_channel * 3.0).to(torch.int64), max=2)
    sig_c = torch.gather(sigma_t, -1, channel[..., None])[..., 0]
    sig_c = torch.clamp(sig_c, min=1e-18)
    dist = (-flog(torch.clamp(1.0 - u_dist, min=1e-18)) / sig_c).detach()
    scattered = dist < t_max
    t_scatter = torch.minimum(dist, t_max)
    tr = medium_tr(sigma_t, t_scatter)
    density = torch.where(scattered[..., None], sigma_t * tr, tr)
    pdf = (density[..., 0] + density[..., 1] + density[..., 2]) / 3.0
    pdf = torch.clamp(pdf, min=1e-18)
    weight = torch.where(scattered[..., None], tr * sigma_s / pdf[..., None],
                         tr / pdf[..., None])
    return scattered, t_scatter, weight
