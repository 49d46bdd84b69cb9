"""Interaction assembly (frozen copy of the port's scene/intersect.py,
make_interaction and what it calls; the traversal backends are left out).

Shape kinds: 0 = triangle, 1 = sphere, 2 = quad, 3 = triangle of a
run-time instance, idx = instance * meta.n_obj_tri + object triangle
(types.py).  Every gather index is clamped into its table explicitly.
"""
from __future__ import annotations

import torch

from ..core.math import (fma, vdot, vdot_k, safe_normalize, sphere_uv,
                         offset_ray, unpack3, pack3, sdot, scross, sdot_f,
                         scross_f, sbary_mix, ssafe_normalize,
                         sonb_from_normal)
from .textures import texture_eval
from .types import SHAPE_TRI, SHAPE_SPH, SHAPE_ITRI


def _rows(idx, table):
    return torch.clamp(idx, 0, table.shape[0] - 1)


# ---------------------------------------------------------------------------
# Interaction assembly (gathers at the winning primitive)
# ---------------------------------------------------------------------------

def _tri_barycentrics(origin, direction, tv):
    """(bu, bv, bw, e1, e2) of the hit of each ray on its triangle tv
    [N,3,3], recomputed at the hit (cheaper than storing them).

    The sums of products are rounded as fused multiply-adds, in the order
    the reference package's compiled CPU code contracts them: texture
    coordinates interpolated from these barycentrics are multiplied by the
    texture's width, so at uv ~ 8 on a 512-texel map a one-ulp difference
    moves a bilinear weight by 5e-4 and a normal-mapped shading normal
    with it."""
    dxr, dyr, dzr = unpack3(direction)
    e1 = (tv[:, 1, 0] - tv[:, 0, 0], tv[:, 1, 1] - tv[:, 0, 1],
          tv[:, 1, 2] - tv[:, 0, 2])
    e2 = (tv[:, 2, 0] - tv[:, 0, 0], tv[:, 2, 1] - tv[:, 0, 1],
          tv[:, 2, 2] - tv[:, 0, 2])
    h = scross_f(dxr, dyr, dzr, *e2)
    det = sdot_f(*e1, *h)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    s = (origin[:, 0] - tv[:, 0, 0], origin[:, 1] - tv[:, 0, 1],
         origin[:, 2] - tv[:, 0, 2])
    bu = sdot_f(*s, *h) * inv_det
    q = scross_f(*s, *e1)
    bv = sdot_f(dxr, dyr, dzr, *q) * inv_det
    return bu, bv, 1.0 - bu - bv, e1, e2


def _ref_tangent(ns):
    """normalize(cross(up, ns)), up = (0,1,0) when |ns.x| > 0.9999."""
    big_x = torch.abs(ns[..., 0:1]) > 0.9999
    up = torch.where(big_x, ns.new_tensor([0.0, 1.0, 0.0]),
                     ns.new_tensor([1.0, 0.0, 0.0]))
    return safe_normalize(torch.cross(up.expand_as(ns), ns, dim=-1))


def _instance_triangles(scene, meta, idx, time=None):
    """World-space vertices [N,3,3] of the instanced-triangle hits idx
    (= inst * n_obj_tri + object triangle), at the rays' times when the
    scene moves, with the clamped (instance, object triangle) ids."""
    iid = torch.clamp(idx // meta.n_obj_tri, 0, scene["inst_fwd"].shape[0] - 1)
    oid = torch.clamp(idx % meta.n_obj_tri, 0, scene["otri_v"].shape[0] - 1)
    fwd = scene["inst_fwd"][iid]                             # [N,3,4]
    ov = scene["otri_v"][oid]                                # [N,3,3]
    ov_w = torch.einsum("nij,nkj->nki", fwd[:, :, :3], ov) + fwd[:, None, :, 3]
    if time is not None:
        # a moving instance only translates: normals are unchanged
        ov_w = ov_w + (scene["inst_vel"][iid] * time[:, None])[:, None, :]
    return ov_w, iid, oid


def make_interaction(scene, meta, origin, direction, hit, time=None,
                     lite: bool = False):
    """Surface interaction for a hit batch: dict(valid, t, p_raw, p, n, ns,
    tangent, uv, mat_id, light_id, med_id, kind, idx).

      triangle: barycentric interpolation of the shading normal (flipped to
                the geometric side), integer-ulp offset origin, authored
                tangent made orthogonal to it (Gram-Schmidt) or the ONB
                tangent, normal mapping;
      sphere:   outward normal, sphere uv;
      quad:     two-sided normal, planar uv.
    Miss lanes are sanitized (p = 0, n = ns = +z, ids -1).

    lite=True skips authored-tangent interpolation and normal mapping (the
    ONB tangent is still produced): the alpha restart chain consumes only
    p_raw / n / uv / mat_id, none of which depend on either.  time [N]:
    moving primitives are taken at the ray's shutter time."""
    t = hit["t"]
    idx = hit["idx"]
    kind = hit["kind"]
    p_raw = fma(t[:, None], direction, origin)   # rounded as a fused mul-add
    motion = meta.has_motion and time is not None
    want_tan = meta.has_tangents and not lite

    # --- triangle (one packed row gather: verts 9, normals 9, uvs 6, prop 4)
    pk_row = scene["tri_pack"][_rows(idx, scene["tri_pack"])]
    tv = pk_row[:, 0:9].reshape(-1, 3, 3)
    tn = pk_row[:, 9:18].reshape(-1, 3, 3)
    tuv = pk_row[:, 18:24].reshape(-1, 3, 2)
    tprop = pk_row[:, 24:28].to(torch.int64)
    ttan = scene["tri_tan"][_rows(idx, scene["tri_tan"])] if want_tan \
        else None
    if motion:
        tvel = scene["tri_vel"][_rows(idx, scene["tri_vel"])]
        tv = tv + (tvel * time[:, None])[:, None, :]
    if meta.n_inst:
        # instanced-triangle hits: gather the object-space data, take it
        # to world space, then run the triangle math (kind folds to TRI)
        is_itri = kind == SHAPE_ITRI
        ov_w, iid, oid = _instance_triangles(scene, meta, idx,
                                             time if motion else None)
        on_w = safe_normalize(torch.einsum("nij,nkj->nki",
                                           scene["inst_nrm"][iid],
                                           scene["otri_n"][oid]))
        m3 = is_itri[:, None, None]
        tv = torch.where(m3, ov_w, tv)
        tn = torch.where(m3, on_w, tn)
        tuv = torch.where(m3, scene["otri_uv"][oid], tuv)
        if want_tan:
            otan_w = torch.einsum("nij,nkj->nki",
                                  scene["inst_fwd"][iid][:, :, :3],
                                  scene["otri_tan"][oid])
            ttan = torch.where(m3, otan_w, ttan)
        tprop = torch.where(is_itri[:, None],
                            scene["otri_prop"][oid].to(torch.int64), tprop)
        # per-instance area lights
        lbase = scene["inst_slot_base"][iid].to(torch.int64)
        lslot = lbase + (oid - scene["inst_base"][iid].to(torch.int64))
        ilight = torch.where(
            (lbase >= 0) & is_itri,
            scene["ilight_map"][_rows(lslot, scene["ilight_map"])]
            .to(torch.int64), -1)
        tprop = torch.cat([tprop[:, 0:1],
                           torch.where(is_itri, ilight, tprop[:, 1])[:, None],
                           tprop[:, 2:]], 1)
        kind = torch.where(is_itri, SHAPE_TRI, kind)
    dxr, dyr, dzr = unpack3(direction)
    bu, bv, bw, (e1x, e1y, e1z), (e2x, e2y, e2z) = _tri_barycentrics(
        origin, direction, tv)
    tri_uv = sbary_mix(bu[:, None], bv[:, None], bw[:, None], tuv[:, 0],
                       tuv[:, 1], tuv[:, 2])
    nsx, nsy, nsz = ssafe_normalize(
        *(sbary_mix(bu, bv, bw, tn[:, 0, c], tn[:, 1, c], tn[:, 2, c])
          for c in range(3)))
    ngx, ngy, ngz = ssafe_normalize(*scross(e1x, e1y, e1z, e2x, e2y, e2z))
    flip_ns = sdot(ngx, ngy, ngz, nsx, nsy, nsz) < 0
    nsx = torch.where(flip_ns, -nsx, nsx)
    nsy = torch.where(flip_ns, -nsy, nsy)
    nsz = torch.where(flip_ns, -nsz, nsz)
    _, (fbx, fby, fbz) = sonb_from_normal(nsx, nsy, nsz)
    if want_tan:
        trx = bu * ttan[:, 1, 0] + bv * ttan[:, 2, 0] + bw * ttan[:, 0, 0]
        try_ = bu * ttan[:, 1, 1] + bv * ttan[:, 2, 1] + bw * ttan[:, 0, 1]
        trz = bu * ttan[:, 1, 2] + bv * ttan[:, 2, 2] + bw * ttan[:, 0, 2]
        has_tan = tprop[:, 3] > 0
        ns_dot_tr = sdot(nsx, nsy, nsz, trx, try_, trz)
        tgx, tgy, tgz = ssafe_normalize(trx - nsx * ns_dot_tr,
                                        try_ - nsy * ns_dot_tr,
                                        trz - nsz * ns_dot_tr)
        tan_t = pack3(torch.where(has_tan, tgx, fbx),
                      torch.where(has_tan, tgy, fby),
                      torch.where(has_tan, tgz, fbz))
    else:   # no triangle in the scene has authored tangents
        tan_t = pack3(fbx, fby, fbz)
    ns_t = pack3(nsx, nsy, nsz)
    ng_t = pack3(ngx, ngy, ngz)
    off_sign = torch.where(sdot(dxr, dyr, dzr, ngx, ngy, ngz) > 0,
                           -1.0, 1.0)[:, None]
    p_t = offset_ray(p_raw, ng_t * off_sign)

    # --- sphere
    si = _rows(idx, scene["sph_c"])
    sc = scene["sph_c"][si]
    if motion:
        sc = sc + scene["sph_vel"][si] * time[:, None]
    sprop = scene["sph_prop"][si].to(torch.int64)
    ns_s = safe_normalize(p_raw - sc)
    p_s = offset_ray(p_raw, ns_s)
    uv_s = sphere_uv(ns_s)
    tan_s = _ref_tangent(ns_s)

    # --- quad
    qi = _rows(idx, scene["quad_q"])
    qq_p = scene["quad_q"][qi]
    if motion:
        qq_p = qq_p + scene["quad_vel"][qi] * time[:, None]
    qn = scene["quad_n"][qi]
    qprop = scene["quad_prop"][qi].to(torch.int64)
    flip_q = vdot_k(direction, qn) > 0
    ns_q = torch.where(flip_q, -qn, qn)
    planar = p_raw - qq_p
    alpha = vdot(scene["quad_w"][qi],
                 torch.cross(planar, scene["quad_v"][qi], dim=-1))
    beta = vdot(scene["quad_w"][qi],
                torch.cross(scene["quad_u"][qi], planar, dim=-1))
    uv_q = torch.stack([alpha, beta], -1)
    tan_q = _ref_tangent(ns_q)
    p_q = offset_ray(p_raw, ns_q)

    is_t = (kind == SHAPE_TRI)[:, None]
    is_s = (kind == SHAPE_SPH)[:, None]

    def pick(a_t, a_s, a_q):
        return torch.where(is_t, a_t, torch.where(is_s, a_s, a_q))

    def pick_id(col):
        return torch.where(kind == SHAPE_TRI, tprop[:, col],
                           torch.where(kind == SHAPE_SPH, sprop[:, col],
                                       qprop[:, col]))

    ok = hit["valid"]
    okn = ok[:, None]
    ns = pick(ns_t, ns_s, ns_q)
    tangent = pick(tan_t, tan_s, tan_q)
    uv = pick(tri_uv, uv_s, uv_q)
    mat_id = pick_id(0)
    # normal mapping, where the material has a normal texture
    if meta.n_mat and meta.has_normal_maps and not lite:
        norm_tex = scene["mat_tex"][_rows(mat_id, scene["mat_tex"]), 3]
        has_norm = (norm_tex >= 0) & (mat_id >= 0) & ok
        nmap = texture_eval(scene, norm_tex, uv)
        n_local = safe_normalize(2.0 * nmap - 1.0)
        # local frame: axis 0 the tangent, 1 cross(ns, tangent), 2 ns
        bitan = torch.cross(ns, tangent, dim=-1)
        ns_mapped = safe_normalize(n_local[:, 0:1] * tangent
                                   + n_local[:, 1:2] * bitan
                                   + n_local[:, 2:3] * ns)
        ns = torch.where(has_norm[:, None], ns_mapped, ns)
    up = p_raw.new_tensor([0.0, 0.0, 1.0]).expand_as(p_raw)
    right = p_raw.new_tensor([1.0, 0.0, 0.0]).expand_as(p_raw)
    # miss lanes: with t = BIG_F32 the hit point overflows; sanitize them
    it = dict(
        valid=ok, t=t, kind=kind, idx=hit["idx"],
        p_raw=torch.where(okn, p_raw, 0.0),
        p=torch.where(okn, pick(p_t, p_s, p_q), 0.0),
        n=torch.where(okn, pick(ng_t, ns_s, qn), up),
        ns=torch.where(okn, ns, up),
        tangent=torch.where(okn, tangent, right),
        uv=torch.where(okn, uv, 0.0),
        mat_id=torch.where(ok, mat_id, -1),
        light_id=torch.where(ok, pick_id(1), -1),
        med_id=torch.where(ok, pick_id(2), -1))
    # geometry is detached from autograd: gradients reach material,
    # texture, light and medium parameters (the detached-sampling
    # estimator); geometric derivatives need estimators of their own
    return {k: v.detach() for k, v in it.items()}
