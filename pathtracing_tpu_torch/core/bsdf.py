"""Table-driven BSDFs (counterpart of pathtracing_tpu/core/bsdf.py).

Every lane carries a material type id plus resolved parameters; all four
material models are evaluated with masks and the results selected by type
(branch-free dispatch, so a batch of mixed materials runs as a few large
tensor ops).  Geometry runs on (x, y, z) component triples of [N] tensors;
colors stay [N,3].

Material types:
  0 MICROFACET_DIFFUSE    (metallic-roughness diffuse + GGX specular)
  1 MICROFACET_DIELECTRIC (rough/smooth glass)
  2 THIN_DIELECTRIC       (thin slab)
  3 SPECULAR_CONDUCTOR    (perfect mirror)
"""
from __future__ import annotations

import math

import torch

from .math import (fcos, fsin, fsqrt, INV_PI, safe_denom, offset_ray,
                   unpack3, pack3, sdot, scross, ssafe_normalize,
                   snormalize, sreflect, srefract,
                   sonb_from_normal, sto_local, sto_world)

MAT_DIFFUSE = 0
MAT_DIELECTRIC = 1
MAT_THIN_DIELECTRIC = 2
MAT_CONDUCTOR = 3

FLAG_TRANSMISSIVE = 1
FLAG_SPECULAR = 2


def _dot(a, b):
    return sdot(a[0], a[1], a[2], b[0], b[1], b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _sel(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def _detached(a):
    return (a[0].detach(), a[1].detach(), a[2].detach())


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel with the internal-side eta flip."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    inside = cos_i < 0
    eta = torch.where(inside, 1.0 / eta, eta)
    cos_i = torch.abs(cos_i)
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = fsqrt(torch.where(tir, 1.0,
                                   torch.clamp(1.0 - sin2_t, min=1e-24)))
    denom_a = eta * cos_i + cos_t
    denom_b = cos_i + eta * cos_t
    r_parl = (eta * cos_i - cos_t) / safe_denom(denom_a, 1e-9)
    r_perp = (cos_i - eta * cos_t) / safe_denom(denom_b, 1e-9)
    return torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def fresnel_schlick(cos_theta, f0):
    """Schlick approximation; f0 is [...,3]."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)[..., None]
    m2 = m * m
    return f0 + (1.0 - f0) * (m * (m2 * m2))    # x^5 as integer_pow does


# ---------------------------------------------------------------------------
# Isotropic GGX
# ---------------------------------------------------------------------------

def roughness_to_alpha(r):
    return r * r


def _ggx_lambda(wz, alpha):
    cos2 = wz * wz
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    tan2 = sin2 / torch.clamp(cos2, min=1e-18)
    lam = 0.5 * (fsqrt(1.0 + alpha * alpha * tan2) - 1.0)
    return torch.where(cos2 == 0.0, 0.0, lam)


def _ggx_d(whz, alpha):
    """GGX NDF in the a^2 / (pi (cos2 (a^2-1) + 1)^2) form (stays finite
    for tiny alpha on masked lanes)."""
    a2 = torch.clamp(alpha * alpha, min=1e-12)
    cos2 = whz * whz
    t = cos2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * t * t, min=1e-18)


def _ggx_g1(wz, alpha):
    return 1.0 / (1.0 + _ggx_lambda(wz, alpha))


def _ggx_g(woz, wiz, alpha):
    return 1.0 / (1.0 + _ggx_lambda(woz, alpha) + _ggx_lambda(wiz, alpha))


def ggx_is_smooth(alpha):
    return alpha < 1e-6


def _ggx_sample_vndf(wo, alpha, u1, u2):
    """Heitz 2018 VNDF sampling, isotropic, with the wo.z < 0 flip."""
    flip = wo[2] < 0.0
    ve = _sel(flip, _neg(wo), wo)
    vh = snormalize(alpha * ve[0], alpha * ve[1], ve[2], eps=1e-18)
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / fsqrt(torch.clamp(lensq, min=1e-18))
    has_xy = lensq > 0.0
    t1 = (torch.where(has_xy, -vh[1] * inv_len, 1.0),
          torch.where(has_xy, vh[0] * inv_len, 0.0),
          torch.zeros_like(vh[2]))
    t2 = scross(*vh, *t1)
    r = fsqrt(torch.clamp(u1, min=0.0))
    phi = 2.0 * math.pi * u2
    p1 = r * fcos(phi)
    p2 = r * fsin(phi)
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * fsqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = fsqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = (p1 * t1[0] + p2 * t2[0] + p3 * vh[0],
          p1 * t1[1] + p2 * t2[1] + p3 * vh[1],
          p1 * t1[2] + p2 * t2[2] + p3 * vh[2])
    ne = snormalize(alpha * nh[0], alpha * nh[1],
                    torch.clamp(nh[2], min=0.0), eps=1e-18)
    return _sel(flip, _neg(ne), ne)


def _ggx_vndf_pdf(wo, wh, alpha):
    """D * G1(wo) * |dot(wo,wh)| / |wo.z|."""
    return (_ggx_d(wh[2], alpha) * _ggx_g1(wo[2], alpha)
            * torch.abs(_dot(wo, wh) / safe_denom(wo[2], 1e-9)))


def material_lanes(mat_type, base_color, roughness, metallic, ior):
    """Per-lane resolved material parameters."""
    return dict(type=mat_type, base_color=base_color, roughness=roughness,
                metallic=metallic, ior=ior)


def _geom(ray_dir, it):
    """Component triples of the interaction + the two local frames."""
    rd = unpack3(ray_dir)
    ns = unpack3(it["ns"])
    n = unpack3(it["n"])
    tan = unpack3(it["tangent"])
    facing = _dot(rd, ns) > 0.0
    ns_flip = _sel(facing, _neg(ns), ns)
    t_f, b_f = sonb_from_normal(*ns_flip)
    flip_frame = (t_f, b_f, ns_flip)                      # diffuse frame
    tan_frame = (tan, scross(*ns, *tan), ns)              # dielectric frame
    ng_facing = _sel(_dot(rd, n) > 0.0, _neg(n), n)
    return dict(rd=rd, ns=ns, n=n, ns_flip=ns_flip, ng_facing=ng_facing,
                flip_frame=flip_frame, tan_frame=tan_frame,
                p=it["p"], p_raw=it["p_raw"])


# ---------------------------------------------------------------------------
# MicrofacetDiffuse
# ---------------------------------------------------------------------------

def _diffuse_sample_prob(roughness):
    return torch.where(roughness >= 0.7, 1.0, 0.5)


def _diffuse_f_pdf(base_color, metallic, roughness, wo, wi, wh):
    """Shared diffuse + specular lobe; returns (f [N,3], denom [N])."""
    alpha = roughness_to_alpha(roughness)
    f0 = (1.0 - metallic[..., None]) * 0.04 + metallic[..., None] * base_color
    fr = fresnel_schlick(_dot(wi, wh), f0)
    num = (_ggx_d(wh[2], alpha) * _ggx_g(wo[2], wi[2], alpha))[..., None] * fr
    denom = torch.abs(4.0 * wo[2] * wi[2])
    spec = num / torch.clamp(denom, min=1e-18)[..., None]
    spec = torch.where((denom == 0.0)[..., None], 0.0, spec)
    kd = (1.0 - fr) * (1.0 - metallic[..., None])
    return kd * base_color * INV_PI + spec, denom


def _cosine_sample_hemisphere(uv2):
    z = fsqrt(torch.clamp(1.0 - uv2[..., 1], min=0.0))
    phi = 2.0 * math.pi * uv2[..., 0]
    s = fsqrt(torch.clamp(uv2[..., 1], min=0.0))
    return fcos(phi) * s, fsin(phi) * s, z


def _diffuse_sample(mat, g, u, uv2):
    t, b, n = g["flip_frame"]
    roughness = torch.clamp(mat["roughness"], min=1e-4)
    alpha = roughness_to_alpha(roughness)
    prob = _diffuse_sample_prob(roughness)
    wo = sto_local(t, b, n, *_neg(g["rd"]))
    take_spec = u >= prob
    # detached sampling: the sampled half-vector is a constant for
    # autograd; f and pdf stay differentiable in roughness through D / G
    wh_s = _detached(_ggx_sample_vndf(wo, alpha, uv2[..., 0], uv2[..., 1]))
    wi_s = sreflect(*_neg(wo), *wh_s)
    wi_d = _cosine_sample_hemisphere(uv2)
    wh_d = ssafe_normalize(wo[0] + wi_d[0], wo[1] + wi_d[1],
                           wo[2] + wi_d[2])
    wi = _sel(take_spec, wi_s, wi_d)
    wh = _sel(take_spec, wh_s, wh_d)
    valid = wi[2] > 0.0

    diffuse_pdf = prob * wi[2] * INV_PI
    spec_pdf = ((1.0 - prob) * _ggx_vndf_pdf(wo, wh, alpha)
                / (4.0 * torch.clamp(torch.abs(_dot(wo, wh)), min=1e-18)))
    pdf = diffuse_pdf + spec_pdf

    f, denom = _diffuse_f_pdf(mat["base_color"], mat["metallic"], roughness,
                              wo, wi, wh)
    valid = valid & (denom != 0.0)
    wi_world = sto_world(t, b, n, *wi)
    flags = torch.zeros_like(u, dtype=torch.int32)
    return wi_world, f, pdf, flags, valid, g["p"]


def _diffuse_eval_pdf(mat, g, wi_w):
    t, b, n = g["flip_frame"]
    roughness = torch.clamp(mat["roughness"], min=1e-4)
    alpha = roughness_to_alpha(roughness)
    rd = g["rd"]
    wo = sto_local(t, b, n, *_neg(rd))
    wi = sto_local(t, b, n, *wi_w)
    wh = ssafe_normalize(wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2])
    f, _ = _diffuse_f_pdf(mat["base_color"], mat["metallic"], roughness,
                          wo, wi, wh)
    # PDF: wh from scattered-incoming; the specular term deliberately omits
    # the (1-prob) factor, as the reference package does (MIS-weight parity)
    whp_w = ssafe_normalize(wi_w[0] - rd[0], wi_w[1] - rd[1],
                            wi_w[2] - rd[2])
    wh_pdf = sto_local(t, b, n, *whp_w)
    prob = _diffuse_sample_prob(roughness)
    diffuse = prob * torch.abs(_dot(g["ns"], wi_w)) * INV_PI
    spec = (_ggx_vndf_pdf(wo, wh_pdf, alpha)
            / (4.0 * torch.clamp(torch.abs(_dot(wo, wh_pdf)), min=1e-18)))
    return f, diffuse + spec


# ---------------------------------------------------------------------------
# MicrofacetDielectric
# ---------------------------------------------------------------------------

def _offset_pair(cond, p_raw, ng_facing):
    ng = pack3(*ng_facing)
    return torch.where(cond[..., None], offset_ray(p_raw, ng),
                       offset_ray(p_raw, -ng))


def _dielectric_sample(mat, g, u, uv2):
    t, b, n = g["tan_frame"]
    ns = g["ns"]
    ns_flip = g["ns_flip"]
    ng_facing = g["ng_facing"]
    rd = g["rd"]
    ri = mat["ior"]
    roughness = mat["roughness"]
    alpha = roughness_to_alpha(roughness)
    smooth = (ri == 1.0) | ggx_is_smooth(alpha)

    wo = sto_local(t, b, n, *_neg(rd))
    eta = torch.where(_dot(_neg(rd), ns) > 0.0, 1.0 / ri, ri)
    p_raw = g["p_raw"]
    base = mat["base_color"]

    # ---- smooth path
    f_s = fresnel_dielectric(wo[2], ri)
    r_s = f_s
    refl_s = u < r_s
    dir_refl_s = sto_world(t, b, n, -wo[0], -wo[1], wo[2])
    dir_refr_s = srefract(*rd, *ns_flip, eta)
    refr_tir = _dot(dir_refr_s, dir_refr_s) == 0.0
    dir_smooth = _sel(refl_s, dir_refl_s, dir_refr_s)
    origin_smooth = _offset_pair(refl_s, p_raw, ng_facing)
    denom_s = torch.clamp(torch.abs(_dot(ns, dir_smooth)), min=1e-18)
    fval_smooth = base * (torch.where(refl_s, r_s, 1.0 - r_s)
                          / denom_s)[..., None]
    pdf_smooth = torch.where(refl_s, r_s, 1.0 - r_s)
    valid_smooth = refl_s | ~refr_tir
    flags_smooth = torch.full_like(u, FLAG_TRANSMISSIVE | FLAG_SPECULAR,
                                   dtype=torch.int32)

    # ---- rough path; wh detached (see _diffuse_sample)
    wh = _detached(_ggx_sample_vndf(wo, alpha, uv2[..., 0], uv2[..., 1]))
    f_r = fresnel_dielectric(_dot(wo, wh), 1.0 / eta)
    r_r = f_r
    t_r = 1.0 - r_r
    refl_r = u < r_r / torch.clamp(r_r + t_r, min=1e-18)

    wi_refl = sreflect(*_neg(wo), *wh)
    valid_refl = wo[2] * wi_refl[2] >= 0.0
    pdf_refl = (_ggx_vndf_pdf(wo, wh, alpha)
                / (4.0 * torch.clamp(torch.abs(_dot(wo, wh)), min=1e-18))
                * r_r)
    f_refl = base * (_ggx_d(wh[2], alpha)
                     * _ggx_g(wo[2], wi_refl[2], alpha) * r_r
                     / torch.clamp(torch.abs(4.0 * wi_refl[2] * wo[2]),
                                   min=1e-18))[..., None]

    wi_refr = srefract(*_neg(wo), *wh, eta)
    valid_refr = ((wo[2] * wi_refr[2] <= 0.0) & (wi_refr[2] != 0.0)
                  & (_dot(wi_refr, wi_refr) > 0.0))
    dwo = _dot(wo, wh)
    dwi = _dot(wi_refr, wh)
    sr = dwi + dwo * eta
    denom_r = torch.clamp(sr * sr, min=1e-18)
    dwh_dwi = torch.abs(dwi) / denom_r
    pdf_refr = _ggx_vndf_pdf(wo, wh, alpha) * dwh_dwi * t_r
    div = denom_r * wi_refr[2] * wo[2]
    div_ok = torch.abs(div) > 1e-16
    ft = (t_r * _ggx_d(wh[2], alpha) * _ggx_g(wo[2], wi_refr[2], alpha)
          * torch.abs(dwi * dwo / safe_denom(div, 1e-16)))
    ft = torch.where(valid_refr & div_ok, ft, 0.0)
    f_refr = base * ft[..., None]

    wi_rough = _sel(refl_r, wi_refl, wi_refr)
    dir_rough = sto_world(t, b, n, *wi_rough)
    origin_rough = _offset_pair(refl_r, p_raw, ng_facing)
    fval_rough = torch.where(refl_r[..., None], f_refl, f_refr)
    pdf_rough = torch.where(refl_r, pdf_refl, pdf_refr)
    valid_rough = torch.where(refl_r, valid_refl, valid_refr)
    flags_rough = torch.where(roughness < 0.001,
                              FLAG_TRANSMISSIVE | FLAG_SPECULAR,
                              FLAG_TRANSMISSIVE).to(torch.int32)

    wi_world = _sel(smooth, dir_smooth, dir_rough)
    f = torch.where(smooth[..., None], fval_smooth, fval_rough)
    pdf = torch.where(smooth, pdf_smooth, pdf_rough)
    flags = torch.where(smooth, flags_smooth, flags_rough)
    valid = torch.where(smooth, valid_smooth, valid_rough)
    origin = torch.where(smooth[..., None], origin_smooth, origin_rough)
    return wi_world, f, pdf, flags, valid, origin


def _dielectric_eval_pdf(mat, g, wi_w):
    t, b, n = g["tan_frame"]
    rd = g["rd"]
    ri = mat["ior"]
    roughness = mat["roughness"]
    alpha = roughness_to_alpha(roughness)
    smooth = (ri == 1.0) | ggx_is_smooth(alpha)

    wo = sto_local(t, b, n, *_neg(rd))
    wi = sto_local(t, b, n, *wi_w)
    cos_o = wo[2]
    cos_i = wi[2]
    is_reflect = cos_i * cos_o > 0.0
    etap = torch.where(is_reflect, 1.0,
                       torch.where(cos_o > 0.0, ri, 1.0 / ri))
    wh = (wi[0] * etap + wo[0], wi[1] * etap + wo[1], wi[2] * etap + wo[2])
    wh_zero = _dot(wh, wh) == 0.0
    one = torch.ones_like(wh[0])
    wh = _sel(wh_zero, (one, one, one), wh)
    wh = ssafe_normalize(*wh)
    wh = _sel(wh[2] < 0.0, _neg(wh), wh)
    degenerate = ((_dot(wh, wi) * cos_i <= 0.0)
                  | (_dot(wh, wo) * cos_o <= 0.0))

    fr = fresnel_dielectric(_dot(wo, wh), ri)
    r = fr
    tt = 1.0 - r

    vpdf = _ggx_vndf_pdf(wo, wh, alpha)
    pdf_reflect = (vpdf / (4.0 * torch.clamp(torch.abs(_dot(wo, wh)),
                                             min=1e-18))
                   * r / torch.clamp(r + tt, min=1e-18))
    sp = _dot(wi, wh) + _dot(wo, wh) / etap
    denom_pdf = torch.clamp(sp * sp, min=1e-18)
    dwh_dwi = torch.abs(_dot(wi, wh)) / denom_pdf
    pdf_refract = vpdf * dwh_dwi * tt / torch.clamp(r + tt, min=1e-18)
    pdf = torch.where(is_reflect, pdf_reflect, pdf_refract)

    base = mat["base_color"]
    d = _ggx_d(wh[2], alpha)
    gg = _ggx_g(cos_o, cos_i, alpha)
    f_reflect = base * (d * gg * fr / torch.clamp(
        torch.abs(4.0 * cos_i * cos_o), min=1e-18))[..., None]
    denom_f = denom_pdf * cos_i * cos_o
    ft = d * (1.0 - fr) * gg * torch.abs(
        _dot(wi, wh) * _dot(wo, wh) / safe_denom(denom_f, 1e-16))
    f_refract = base * ft[..., None]
    f = torch.where(is_reflect[..., None], f_reflect, f_refract)

    bad = smooth | wh_zero | degenerate
    f = torch.where(bad[..., None], 0.0, f)
    pdf = torch.where(bad, 0.0, pdf)
    return f, pdf


# ---------------------------------------------------------------------------
# ThinDielectric
# ---------------------------------------------------------------------------

def _thin_sample(mat, g, u, uv2):
    t, b, n = g["tan_frame"]
    ns = g["ns"]
    rd = g["rd"]
    wo = sto_local(t, b, n, *_neg(rd))
    fr = fresnel_dielectric(wo[2], mat["ior"])
    r = fr
    tt = 1.0 - r
    # interreflection series
    r_adj = torch.where(r < 1.0,
                        r + tt * tt * r / torch.clamp(1.0 - r * r, min=1e-18),
                        r)
    t_adj = 1.0 - r_adj

    take_refl = u < r_adj
    dir_refl = sto_world(t, b, n, -wo[0], -wo[1], wo[2])
    wi_world = _sel(take_refl, dir_refl, rd)
    origin = _offset_pair(take_refl, g["p_raw"], g["ng_facing"])
    denom = torch.clamp(torch.abs(_dot(ns, wi_world)), min=1e-18)
    amount = torch.where(take_refl, r_adj, t_adj)
    f = mat["base_color"] * (amount / denom)[..., None]
    pdf = amount
    flags = torch.full_like(u, FLAG_TRANSMISSIVE | FLAG_SPECULAR,
                            dtype=torch.int32)
    valid = torch.ones_like(u, dtype=torch.bool)
    return wi_world, f, pdf, flags, valid, origin


# ---------------------------------------------------------------------------
# SpecularConductor
# ---------------------------------------------------------------------------

def _conductor_sample(mat, g, u, uv2):
    ns = g["ns"]
    wi_world = sreflect(*g["rd"], *ns)
    d = _dot(wi_world, ns)
    valid = d > 0.0
    f = (fresnel_schlick(_dot(ns, _neg(g["rd"])), mat["base_color"])
         / torch.clamp(d, min=1e-18)[..., None])
    pdf = torch.ones_like(u)
    flags = torch.full_like(u, FLAG_SPECULAR, dtype=torch.int32)
    return wi_world, f, pdf, flags, valid, g["p"]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

ALL_MATS = (True, True, True, True)


def bsdf_sample(mat, ray_dir, it, u, uv2, present=ALL_MATS):
    """Material scatter for every lane.  `present` statically skips the
    material models absent from the scene.  Returns
    (wi [N,3], f [N,3], pdf, flags, valid, origin [N,3]).  The sampling
    decisions are detached (u, uv2, wi, origin); f and pdf stay
    differentiable in the material parameters."""
    u = u.detach()
    uv2 = uv2.detach()
    g = _geom(ray_dir, it)
    fns = [_diffuse_sample, _dielectric_sample, _thin_sample,
           _conductor_sample]
    mtype = mat["type"]
    out = None
    for k in range(4):
        if not present[k]:
            continue
        res = fns[k](mat, g, u, uv2)
        if out is None:
            out = list(res)
            continue
        sel = mtype == k
        wi, f, pdf, flags, valid, origin = res
        out[0] = _sel(sel, wi, out[0])
        out[1] = torch.where(sel[..., None], f, out[1])
        out[2] = torch.where(sel, pdf, out[2])
        out[3] = torch.where(sel, flags, out[3])
        out[4] = torch.where(sel, valid, out[4])
        out[5] = torch.where(sel[..., None], origin, out[5])
    if out is None:
        out = list(_diffuse_sample(mat, g, u, uv2))
    wi3, f, pdf, flags, valid, origin = out
    return pack3(*wi3).detach(), f, pdf, flags, valid, origin.detach()


def bsdf_eval_pdf(mat, ray_dir, it, wi_world, present=ALL_MATS):
    """BSDF value + pdf for NEE / MIS.  Thin dielectric and conductor
    return zeros (specular only)."""
    mtype = mat["type"]
    g = _geom(ray_dir, it)
    wi3 = unpack3(wi_world)
    if present[MAT_DIFFUSE]:
        f, pdf = _diffuse_eval_pdf(mat, g, wi3)
        is_d = mtype == MAT_DIFFUSE
        f = torch.where(is_d[..., None], f, 0.0)
        pdf = torch.where(is_d, pdf, 0.0)
    else:
        f = torch.zeros(wi_world.shape, dtype=wi_world.dtype,
                        device=wi_world.device)
        pdf = torch.zeros(mtype.shape, dtype=torch.float32,
                          device=wi_world.device)
    if present[MAT_DIELECTRIC]:
        f_g, p_g = _dielectric_eval_pdf(mat, g, wi3)
        is_g = mtype == MAT_DIELECTRIC
        f = torch.where(is_g[..., None], f_g, f)
        pdf = torch.where(is_g, p_g, pdf)
    return f, pdf
