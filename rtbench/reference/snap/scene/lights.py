"""Light sampling and evaluation (counterpart of
pathtracing_tpu/scene/lights.py).

A typed light table with branch-free per-type math selected by masks and
a CDF-based power (or uniform) light sampler.  Kinds: uniform infinite,
environment map (an equirect texture, importance-sampled through its own
luminance table over the (z, azimuth) grid), distant, point, and area
lights on triangles, quads, spheres and the triangles of run-time
instances, with a flat or a textured emission; moving shapes and point
lights are sampled at the ray's shutter time.

Conventions: delta lights (distant/point) are never MIS-weighted; infinite
lights sample directions; area lights sample surface points with the
solid-angle pdf dist^2 / (|cos| * area).
"""
from __future__ import annotations

import math

import torch

from ..core.math import (fatan2, fcos, fsin, fsqrt, vdot, safe_normalize,
                         sphere_uv, uv_to_direction,
                         BIG_F32, pack3, scross, ssafe_normalize, sdot,
                         unpack3)
from .types import (LIGHT_UNIFORM_INF, LIGHT_ENV_TEX, LIGHT_DISTANT,
                    LIGHT_POINT, LIGHT_AREA, SHAPE_TRI, SHAPE_SPH,
                    SHAPE_ITRI)
from .textures import texture_eval

INV_4PI = 1.0 / (4.0 * math.pi)


def _clip_rows(idx, table):
    """Clamp gather indices into `table`'s rows (a CUDA gather faults on
    out-of-range indices)."""
    return torch.clamp(idx, 0, table.shape[0] - 1)


def sample_light_index(scene, meta, u):
    """CDF inversion.  Returns (idx, pmf, valid)."""
    if meta.n_lights == 0:
        z = torch.zeros_like(u)
        return z.to(torch.int64), z, torch.zeros_like(u, dtype=torch.bool)
    cdf = scene["light_cdf"][:meta.n_lights].contiguous()
    idx = torch.searchsorted(cdf, u.contiguous(), right=False)
    idx = torch.clamp(idx, max=meta.n_lights - 1)
    pmf = light_pmf(scene, meta, idx)
    return idx, pmf, pmf > 0


def light_pmf(scene, meta, idx):
    """Selection probability of light `idx`."""
    if meta.n_lights == 0:
        return torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    if meta.light_sampler == "uniform":
        return torch.full(idx.shape, 1.0 / meta.n_lights,
                          dtype=torch.float32, device=idx.device)
    total = scene["light_total_power"][0]
    power = scene["light_power"][_clip_rows(idx, scene["light_power"])]
    return torch.where(total > 0, power / total, 1.0)


def _sample_shape(scene, meta, kind, sidx, uv2, time=None):
    """Uniform point sample on a triangle (sqrt warp), sphere, quad or
    instanced triangle (sidx = inst * n_obj_tri + object triangle: the
    object-space triangle pushed through the instance transform).  Moving
    shapes are sampled at the ray time.  Returns (p, n, uv)."""
    motion = meta.has_motion and time is not None
    ti = _clip_rows(sidx, scene["tri_v"])
    tv = scene["tri_v"][ti]
    if motion:
        tv = tv + (scene["tri_vel"][_clip_rows(sidx, scene["tri_vel"])]
                   * time[:, None])[:, None, :]
    tuv = scene["tri_uv"][_clip_rows(sidx, scene["tri_uv"])]
    su = fsqrt(torch.clamp(uv2[..., 0], min=0.0))
    b1 = 1.0 - su
    b2 = uv2[..., 1] * su
    b0 = 1.0 - b1 - b2
    p_t = (b0[:, None] * tv[:, 0] + b1[:, None] * tv[:, 1]
           + b2[:, None] * tv[:, 2])
    n_t = pack3(*ssafe_normalize(*scross(
        tv[:, 1, 0] - tv[:, 0, 0], tv[:, 1, 1] - tv[:, 0, 1],
        tv[:, 1, 2] - tv[:, 0, 2],
        tv[:, 2, 0] - tv[:, 0, 0], tv[:, 2, 1] - tv[:, 0, 1],
        tv[:, 2, 2] - tv[:, 0, 2])))
    uv_t = (b0[:, None] * tuv[:, 0] + b1[:, None] * tuv[:, 1]
            + b2[:, None] * tuv[:, 2])

    si = _clip_rows(sidx, scene["sph_c"])
    c = scene["sph_c"][si]
    if motion:
        c = c + scene["sph_vel"][si] * time[:, None]
    r = scene["sph_r"][si]
    z = 1.0 - 2.0 * uv2[..., 0]
    rr = fsqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * uv2[..., 1]
    dir_s = torch.stack([rr * fcos(phi), rr * fsin(phi), z], -1)
    p_s = c + r[:, None] * dir_s
    uv_s = sphere_uv(dir_s)

    qi = _clip_rows(sidx, scene["quad_q"])
    qq = scene["quad_q"][qi]
    if motion:
        qq = qq + scene["quad_vel"][qi] * time[:, None]
    p_q = (qq + uv2[..., 0:1] * scene["quad_u"][qi]
           + uv2[..., 1:2] * scene["quad_v"][qi])
    n_q = scene["quad_n"][qi]

    is_t = (kind == SHAPE_TRI)[:, None]
    is_s = (kind == SHAPE_SPH)[:, None]
    p = torch.where(is_t, p_t, torch.where(is_s, p_s, p_q))
    n = torch.where(is_t, n_t, torch.where(is_s, dir_s, n_q))
    uv = torch.where(is_t, uv_t, torch.where(is_s, uv_s, uv2))
    if meta.n_inst:
        ii = torch.clamp(sidx // meta.n_obj_tri, 0,
                         scene["inst_fwd"].shape[0] - 1)
        oi = torch.clamp(sidx % meta.n_obj_tri, 0,
                         scene["otri_v"].shape[0] - 1)
        fwd = scene["inst_fwd"][ii]                          # [N,3,4]
        wv = torch.einsum("nij,nkj->nki", fwd[:, :, :3],
                          scene["otri_v"][oi]) + fwd[:, None, :, 3]
        if motion:
            wv = wv + (scene["inst_vel"][ii] * time[:, None])[:, None, :]
        p_i = (b0[:, None] * wv[:, 0] + b1[:, None] * wv[:, 1]
               + b2[:, None] * wv[:, 2])
        n_i = safe_normalize(torch.cross(wv[:, 1] - wv[:, 0],
                                         wv[:, 2] - wv[:, 0], dim=-1))
        ouv = scene["otri_uv"][oi]
        uv_i = (b0[:, None] * ouv[:, 0] + b1[:, None] * ouv[:, 1]
                + b2[:, None] * ouv[:, 2])
        is_i = (kind == SHAPE_ITRI)[:, None]
        p = torch.where(is_i, p_i, p)
        n = torch.where(is_i, n_i, n)
        uv = torch.where(is_i, uv_i, uv)
    return p, n, uv


def _shape_solid_angle_pdf(area, ref_p, sample_p, sample_n):
    """dist^2 / (|cos| * area)."""
    tx, ty, tz = (sample_p[..., 0] - ref_p[..., 0],
                  sample_p[..., 1] - ref_p[..., 1],
                  sample_p[..., 2] - ref_p[..., 2])
    d2 = tx * tx + ty * ty + tz * tz
    wx, wy, wz = ssafe_normalize(tx, ty, tz)
    nx, ny, nz = unpack3(sample_n)
    cos = torch.abs(sdot(wx, wy, wz, nx, ny, nz))
    denom = cos * area
    return torch.where(denom > 0, d2 / torch.clamp(denom, min=1e-18), 0.0)


# ---------------------------------------------------------------------------
# Environment importance tables
# ---------------------------------------------------------------------------

def _env_cell_of(meta, d):
    """Cell of the (z, azimuth) grid that direction d falls in."""
    u = torch.clamp((d[..., 2] + 1.0) * 0.5, 0.0, 1.0 - 1e-7)
    phi = fatan2(d[..., 1], d[..., 0])
    v = torch.remainder(phi / (2.0 * math.pi), 1.0)
    ix = torch.clamp((u * meta.env_nx).to(torch.int64), max=meta.env_nx - 1)
    iy = torch.clamp((v * meta.env_ny).to(torch.int64), max=meta.env_ny - 1)
    return ix * meta.env_ny + iy


def env_pdf(scene, meta, lid, d):
    """Solid-angle pdf of env light `lid`'s importance sampler at
    direction d; each env light has its own table (light_env_slot)."""
    if meta.env_nx == 0:
        return torch.full(d.shape[:-1], INV_4PI, dtype=torch.float32,
                          device=d.device)
    cell = _env_cell_of(meta, d)
    slot = torch.clamp(
        scene["light_env_slot"][_clip_rows(lid, scene["light_env_slot"])],
        0, max(meta.n_env - 1, 0))
    cell_omega = 4.0 * math.pi / (meta.env_nx * meta.env_ny)
    return scene["env_weights"][slot, cell] / torch.clamp(
        scene["env_total"][slot], min=1e-18) / cell_omega


def env_sample_dir(scene, meta, lid, u_cell, uv2):
    """Importance-sample a direction from env light `lid`'s table: one CDF
    search per env table (meta.n_env is small), each lane taking its
    light's result, then a uniform point in the chosen cell."""
    if meta.env_nx == 0:
        return uv_to_direction(uv2)
    slot = scene["light_env_slot"][_clip_rows(lid, scene["light_env_slot"])]
    ncell = meta.env_nx * meta.env_ny
    u = u_cell.to(torch.float32).contiguous()
    idx = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for e in range(meta.n_env):
        idx_e = torch.searchsorted(scene["env_cdf"][e].contiguous(), u,
                                   right=False)
        idx = torch.where(slot == e, idx_e, idx)
    idx = torch.clamp(idx, max=ncell - 1)
    ix = (idx // meta.env_ny).to(torch.float32)
    iy = (idx % meta.env_ny).to(torch.float32)
    cell_uv = torch.stack([(ix + uv2[..., 0]) / meta.env_nx,
                           (iy + uv2[..., 1]) / meta.env_ny], -1)
    return uv_to_direction(cell_uv)


# ---------------------------------------------------------------------------
# Per-light radiance, sampling and pdfs
# ---------------------------------------------------------------------------

def infinite_le(scene, meta, idx, ray_dir):
    """Radiance of infinite light `idx` toward -ray_dir: a flat color, or
    for an env light its texture at sphere_uv(ray_dir) scaled by the
    light's scale (held in light_color)."""
    lid = _clip_rows(idx, scene["light_color"])
    color = scene["light_color"][lid]
    if not meta.has_emissive_tex:
        # no textured light in the scene: every infinite light is flat
        return color.expand(ray_dir.shape)
    ltype = scene["light_type"][lid]
    emtex = scene["light_emtex"][lid]
    tex = texture_eval(scene, torch.clamp(emtex, min=0), sphere_uv(ray_dir))
    env = color[..., 0:1] * tex
    return torch.where((ltype == LIGHT_ENV_TEX)[..., None], env, color)


def area_light_L(scene, meta, light_id, geom_n, uv, ray_dir):
    """Emission (flat, or the emission texture at uv) toward -ray_dir with
    the one-sided cut on the geometric normal."""
    lid = _clip_rows(light_id, scene["light_type"])
    em = scene["light_color"][lid]
    if meta.has_emissive_tex:
        emtex = scene["light_emtex"][lid]
        tex = texture_eval(scene, torch.clamp(emtex, min=0), uv)
        em = torch.where((emtex >= 0)[..., None], tex, em)
    one_sided = (scene["light_flags"][lid] & 1) > 0
    front = vdot(ray_dir, geom_n) <= 0
    vis = (~one_sided) | front
    return torch.where((vis & (light_id >= 0))[..., None], em, 0.0)


def area_light_hit_pdf(scene, meta, light_id, ref_p, hit_p, hit_n, ray_dir):
    """Solid-angle pdf of hitting area light `light_id` * one-sided cut."""
    lid = _clip_rows(light_id, scene["light_type"])
    area = scene["light_area"][lid]
    pdf = _shape_solid_angle_pdf(area, ref_p, hit_p, hit_n)
    one_sided = (scene["light_flags"][lid] & 1) > 0
    front = vdot(-ray_dir, hit_n) > 0
    pdf = torch.where(one_sided & ~front, 0.0, pdf)
    return torch.where(light_id >= 0, pdf, 0.0)


def light_sample(scene, meta, idx, ref_p, u_cell, uv2, time=None):
    """Sample every lane's light.  Returns dict(is_delta, to_inf, dir,
    dist, p, n, uv, L_delta, ltype)."""
    lid = _clip_rows(idx, scene["light_type"])
    ltype = scene["light_type"][lid]
    color = scene["light_color"][lid]
    lvec = scene["light_vec"][lid]
    shape = scene["light_shape"][lid]

    sph_dir = uv_to_direction(uv2)
    inf_dir = sph_dir          # uniform infinite: uniform sphere direction
    if meta.n_env:
        inf_dir = torch.where((ltype == LIGHT_ENV_TEX)[..., None],
                              env_sample_dir(scene, meta, lid, u_cell, uv2),
                              sph_dir)
    # distant: jittered fixed direction
    dist_dir = safe_normalize(lvec + sph_dir * 0.02)
    p_a, n_a, uv_a = _sample_shape(scene, meta, shape[..., 0],
                                   shape[..., 1], uv2, time)
    if meta.has_light_motion and time is not None:
        # a moving point light sits at position + velocity * time
        lvec = torch.where((ltype == LIGHT_POINT)[..., None],
                           lvec + scene["light_vel"][lid] * time[:, None],
                           lvec)

    is_delta = (ltype == LIGHT_DISTANT) | (ltype == LIGHT_POINT)
    to_inf = ((ltype == LIGHT_UNIFORM_INF) | (ltype == LIGHT_ENV_TEX)
              | (ltype == LIGHT_DISTANT))

    target = torch.where((ltype == LIGHT_POINT)[..., None], lvec, p_a)
    tlx = target[..., 0] - ref_p[..., 0]
    tly = target[..., 1] - ref_p[..., 1]
    tlz = target[..., 2] - ref_p[..., 2]
    dist_pt = fsqrt(torch.clamp(tlx * tlx + tly * tly + tlz * tlz,
                                min=1e-18))
    inv_d = 1.0 / dist_pt
    dir_pt = pack3(tlx * inv_d, tly * inv_d, tlz * inv_d)

    dirn = torch.where(to_inf[..., None],
                       torch.where((ltype == LIGHT_DISTANT)[..., None],
                                   dist_dir, inf_dir),
                       dir_pt)
    dist = torch.where(to_inf, BIG_F32, dist_pt)
    return dict(is_delta=is_delta, to_inf=to_inf, dir=dirn, dist=dist,
                p=target, n=torch.where(to_inf[..., None], 0.0, n_a),
                uv=uv_a, L_delta=color, ltype=ltype)


def light_sample_L(scene, meta, idx, sample, shadow_dir):
    """Radiance of the sampled light along the shadow ray."""
    lid = _clip_rows(idx, scene["light_type"])
    ltype = scene["light_type"][lid]
    inf = infinite_le(scene, meta, lid, shadow_dir)
    area = area_light_L(scene, meta, lid, sample["n"], sample["uv"],
                        shadow_dir)
    return torch.where((ltype == LIGHT_AREA)[..., None], area,
                       torch.where(((ltype == LIGHT_UNIFORM_INF)
                                    | (ltype == LIGHT_ENV_TEX))[..., None],
                                   inf, sample["L_delta"]))


def light_sample_pdf(scene, meta, idx, sample, ref_p, shadow_dir):
    """Solid-angle pdf of the light sample per light kind."""
    lid = _clip_rows(idx, scene["light_type"])
    ltype = scene["light_type"][lid]
    area = scene["light_area"][lid]
    pdf_area = _shape_solid_angle_pdf(area, ref_p, sample["p"], sample["n"])
    one_sided = (scene["light_flags"][lid] & 1) > 0
    front = vdot(-shadow_dir, sample["n"]) > 0
    pdf_area = torch.where(one_sided & ~front, 0.0, pdf_area)
    return torch.where(ltype == LIGHT_AREA, pdf_area,
                       _infinite_pdf(scene, meta, lid, ltype, shadow_dir))


def _infinite_pdf(scene, meta, lid, ltype, d):
    """Direction pdf of uniform-infinite and env lights, 0 for others."""
    pdf = torch.where(ltype == LIGHT_UNIFORM_INF, INV_4PI, 0.0)
    if meta.n_env:
        pdf = torch.where(ltype == LIGHT_ENV_TEX,
                          env_pdf(scene, meta, lid, d), pdf)
    return pdf


def infinite_light_mis_pdf(scene, meta, idx, ray_dir):
    """Solid-angle pdf of an infinite light's direction sampler."""
    lid = _clip_rows(idx, scene["light_type"])
    return _infinite_pdf(scene, meta, lid, scene["light_type"][lid], ray_dir)
