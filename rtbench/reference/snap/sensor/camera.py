"""Thin-lens camera (counterpart of pathtracing_tpu/sensor/camera.py)."""
from __future__ import annotations

import torch

from ..core.math import safe_normalize, in_unit_disk
from ..core.rng import sample_1d, sample_2d


def generate_ray(cam, p, time_u, lens_uv):
    """Camera ray per lane.  p: [N,2] film position in pixels; time_u: [N]
    shutter interpolant; lens_uv: [N,2].  Returns (origin, dir, time)."""
    res_x, res_y = cam["resolution"]
    u_coord = p[..., 0] / res_x
    v_coord = p[..., 1] / res_y
    half_w = cam["half_wh"][0]
    half_h = cam["half_wh"][1]
    direction = safe_normalize(
        -cam["w"] + (2.0 * u_coord - 1.0)[..., None] * half_w * cam["u"]
        + (2.0 * v_coord - 1.0)[..., None] * half_h * cam["v"])
    t = cam["shutter"][0] + (cam["shutter"][1] - cam["shutter"][0]) * time_u

    no_dof = (cam["focus_distance"] == 0.0) | (cam["defocus_radius"] == 0.0)
    p_lens = in_unit_disk(lens_uv)
    offset = (p_lens[..., 0:1] * cam["u"] * cam["defocus_radius"]
              + p_lens[..., 1:2] * cam["v"] * cam["defocus_radius"])
    dir_dof = safe_normalize(direction * cam["focus_distance"] - offset)
    origin = torch.where(no_dof, cam["origin"], cam["origin"] + offset)
    direction = torch.where(no_dof, direction, dir_dof)
    # camera parameters are not gradient targets (detached sampling)
    return origin.detach(), direction.detach(), t.detach()


def film_position(sampler, px, py, sample_idx):
    """Jittered film position for (pixel, sample): dim 0 is the pixel
    jitter, shared by every render path so splats and rays agree."""
    p_jitter = sample_2d(sampler, px, py, sample_idx, 0)
    return torch.stack([px.to(torch.float32), py.to(torch.float32)],
                       dim=-1) + p_jitter


def camera_lanes(cam, sampler, px, py, sample_idx):
    """Per-lane camera sample: film jitter (dim 0), shutter time (dim 2),
    lens uv (dim 3).  Returns (origin, direction, time, p)."""
    time_u = sample_1d(sampler, px, py, sample_idx, 2)
    lens_uv = sample_2d(sampler, px, py, sample_idx, 3)
    p = film_position(sampler, px, py, sample_idx)
    origin, direction, time = generate_ray(cam, p, time_u, lens_uv)
    return origin, direction, time, p
