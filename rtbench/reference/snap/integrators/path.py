"""Wavefront path integrators (counterpart of
pathtracing_tpu/integrators/path.py).

A masked structure-of-arrays bounce loop over ray batches: every lane
carries (origin, dir, throughput, L, prevPDF, spec, alive) and each bounce
advances all lanes at once.  Dead lanes trace with t_max = 0 (the dispatch
sorts them last so their kernel work is nil) and the loop stops when every
lane is dead.  Random numbers are counter-based on (pixel, sample,
dimension), so every render path draws identical streams.

Integrators: "path" (MIS + next-event estimation), "simple" (no NEE) and
"volpath" (path with homogeneous participating media: lanes carry a medium
id, distance sampling in the medium, phase-function scattering, shadow
rays that march through medium boundaries).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import BIG_F32, SHADOW_EPS
from ..core import rng as rngmod
from ..core.rng import SamplerConfig, sample_1d, sample_2d
from ..core.bsdf import (bsdf_sample, bsdf_eval_pdf, material_lanes,
                         FLAG_SPECULAR, FLAG_TRANSMISSIVE)
from ..core.filters import FilterConfig, mitchell
from ..core.math import fma, vdot, vdot_k, offset_ray
from ..core.medium import medium_sample, medium_tr
from ..core.phase import hg_pdf, hg_sample
from ..scene.intersect import make_interaction
from ..scene import lights as L
from ..scene.textures import texture_alpha, texture_eval
from ..scene.types import ALPHA_BLEND, ALPHA_MASK


def _intersect(*args, **kwargs):
    """The reference traces with its own scan (rtbench/reference/scan.py)
    and replays bounces with the program's judged traversal answers."""
    raise NotImplementedError("the reference traces with its own scan")


_occluded = _intersect

# per-bounce random dimension layout (camera uses dims 0..4)
_DIM_BASE = 5
_DIM_STRIDE = 16
_D_SCATTER_UV = 0
_D_LIGHT_UV = 2
_D_SCATTER_U = 4
_D_LIGHT_SELECT = 5
_D_RR = 6
_D_PHASE = 7
_D_ENV_CELL = 9
_D_MED_CHANNEL = 10
_D_MED_DIST = 11
_D_ALPHA = 12
# drain-tail statistics of the regenerating tracer: a lane at or past
# _DEEP_BOUNCE is deep, and a deep lane's closest hit nearer than _REHIT_T
# is a re-hit (a see-through restart that found its own triangle again)
_DEEP_BOUNCE = 20
_REHIT_T = 1e-4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Same fields as the reference package's RenderConfig.

    differentiable=True makes `trace` (and so `render_tile`) the scan form:
    exactly max_depth bounces, no early exit, gradients through autograd to
    the material, texture, light and medium arrays (sampling and geometry
    are detached).  remat=True runs each of its bounces under
    torch.utils.checkpoint with the traversal outputs kept, so the backward
    pass recomputes the shade math only and launches no traversal kernel.
    With regenerate=True as well, `render` drains its queues through
    regen_diff.trace_regen_diff (the recording wavefront); volpath keeps
    the scan form.  compact_after=c: after c bounces, on batches of 4,096
    lanes or more, the surviving lanes continue in a quarter-width batch
    (both forms of `trace`; the regenerating tracer ignores it)."""
    spp: int = 16
    max_depth: int = 8
    integrator: str = "path"        # simple | path | volpath
    sampler: SamplerConfig = SamplerConfig(kind="stratified",
                                           x_samples=4, y_samples=4)
    filter: FilterConfig = mitchell()
    rr_start: int = 3               # Russian roulette after this many scatters
    rays_per_batch: int = 1 << 16   # lanes in flight per batch
    differentiable: bool = False    # the scan form (gradients)
    remat: bool = True              # checkpoint each bounce of the scan form
    compact_after: int | None = None    # tail compaction (None: off)
    regenerate: bool = False        # persistent wavefront (trace_regen)


def _check_cfg(cfg: RenderConfig, meta):
    if cfg.integrator not in ("path", "simple", "volpath"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")


def resolve_material(scene, meta, it):
    """Per-lane material parameters with textures applied: the base
    texture modulates the base color, roughness reads the G channel and
    metallic the B channel of their textures.  A slot no material of the
    scene uses (meta.mat_tex_present) is skipped outright."""
    mid = torch.clamp(it["mat_id"], 0, scene["mat_type"].shape[0] - 1)
    mtype = torch.where(it["mat_id"] >= 0,
                        scene["mat_type"][mid].to(torch.int64), -1)
    base = scene["mat_base"][mid]
    rough = scene["mat_rough"][mid]
    metal = scene["mat_metal"][mid]
    present = meta.mat_tex_present
    if meta.n_mat and any(present[:3]):
        tex_ids = scene["mat_tex"][mid]
    if meta.n_mat and present[0]:
        bt = tex_ids[:, 0]
        base = torch.where((bt >= 0)[:, None],
                           base * texture_eval(scene, bt, it["uv"]), base)
    if meta.n_mat and present[1]:
        rt = tex_ids[:, 1]
        rough = torch.where(rt >= 0,
                            rough * texture_eval(scene, rt, it["uv"])[:, 1],
                            rough)
    if meta.n_mat and present[2]:
        mt = tex_ids[:, 2]
        metal = torch.where(mt >= 0,
                            metal * texture_eval(scene, mt, it["uv"])[:, 2],
                            metal)
    return material_lanes(mtype, base, rough, metal, scene["mat_ior"][mid])


# ---------------------------------------------------------------------------
# Transmittance marching
# ---------------------------------------------------------------------------

# A degenerate-geometry safety net, not a budget: the reference marches
# until every lane has left its last boundary
_MAX_MARCHES = 64


def transmittance(scene, meta, origin, direction, dist, medium, active,
                  time=None):
    """March shadow rays through material-less medium boundaries,
    accumulating the transmittance of each medium segment.  A surface with
    a material blocks the ray.  Returns (Tr [N,3], blocked [N]).  One host
    sync per march (the .item() below); finished lanes march zero-length
    segments (t_max = 0: no kernel work)."""
    n = origin.shape[0]
    dev = origin.device
    n_med = scene["med_sigma_t"].shape[0]

    def med_tr(med, t):
        sig = scene["med_sigma_t"][torch.clamp(med, 0, n_med - 1)]
        return torch.where((med >= 0)[:, None], medium_tr(sig, t), 1.0)

    o, rem, med = origin, dist, medium
    tr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    live = active
    i = 0
    while i < _MAX_MARCHES and bool(live.any().item()):
        h = _intersect(scene, meta, o, direction,
                       torch.where(live, rem, 0.0), time)
        it = make_interaction(scene, meta, o, direction, h, time=time,
                              lite=True)
        seg = torch.where(h["valid"], h["t"], rem)
        tr = torch.where(live[:, None], tr * med_tr(med, seg), tr)
        hit_mat = h["valid"] & (it["mat_id"] >= 0)
        blocked = blocked | (live & hit_mat)
        go_on = live & h["valid"] & ~hit_mat
        # the medium on the far side of the boundary
        new_med = torch.where(vdot(direction, it["n"]) < 0.0, it["med_id"],
                              -1)
        med = torch.where(go_on, new_med, med)
        # step past the boundary with a scale-robust offset (an absolute
        # epsilon is below one ulp at large coordinates)
        n_fwd = torch.where(vdot_k(direction, it["n"]) > 0, it["n"],
                            -it["n"])
        o = torch.where(go_on[:, None], offset_ray(it["p_raw"], n_fwd), o)
        rem = torch.where(go_on, rem - h["t"], rem)
        live = go_on & (rem > 0)
        i += 1
    return tr, blocked


# ---------------------------------------------------------------------------
# Next-event estimation
# ---------------------------------------------------------------------------

def sample_ld(scene, meta, cfg, ray_dir, it, mat, u_select, uv_light, u_cell,
              alpha_salt, active, occ_stats=None, time=None,
              is_medium_vertex=None, medium=None, g_lanes=None,
              volumetric: bool = False, occ=None, want_occ: bool = False):
    """One-light next-event estimate.  alpha_salt keys the shadow
    predicate's BLEND random numbers; occ_stats is handed to it
    (scene/intersect.py::_occluded); time [N] is the rays' shutter time
    (lights are sampled and shadow rays traced at it).  Volumetric
    (integrator "volpath"): is_medium_vertex [N] marks medium scatter
    vertices, which take the HG phase function (asymmetry g_lanes) in
    place of the BSDF and no backface rejection; shadow rays march through
    the medium boundaries from `medium` (transmittance) in place of the
    shadow predicate.  occ [N] bool: recorded shadow-predicate results to
    use in place of the predicate (the replaying bounce); want_occ=True
    returns (contribution, occ) so a recording bounce can keep them."""
    if meta.n_lights == 0:
        z = torch.zeros_like(ray_dir)
        return (z, torch.zeros_like(active)) if want_occ else z

    lidx, pmf, lvalid = L.sample_light_index(scene, meta, u_select)
    ref_p = it["p"]
    if is_medium_vertex is not None:
        ref_p = torch.where(is_medium_vertex[:, None], it["p_raw"], ref_p)
    ls = L.light_sample(scene, meta, lidx, ref_p, u_cell, uv_light, time)

    sdir = ls["dir"]
    # relative shortening so no light self-occludes at any scene scale
    t_shadow = torch.where(ls["to_inf"], BIG_F32,
                           ls["dist"] * (1.0 - 1e-3) - SHADOW_EPS)

    # backface rejection
    ns = it["ns"]
    cos_s = (ns[:, 0] * sdir[:, 0] + ns[:, 1] * sdir[:, 1]
             + ns[:, 2] * sdir[:, 2])
    cos_o = (ns[:, 0] * ray_dir[:, 0] + ns[:, 1] * ray_dir[:, 1]
             + ns[:, 2] * ray_dir[:, 2])
    surf_reject = cos_s * cos_o >= 0.0

    f, sampling_pdf = bsdf_eval_pdf(mat, ray_dir, it, sdir,
                                    present=meta.mats_present)
    f = f * torch.abs(cos_s)[:, None]
    if is_medium_vertex is not None:
        ph = hg_pdf(ray_dir, sdir, g_lanes)
        f = torch.where(is_medium_vertex[:, None], ph[:, None], f)
        sampling_pdf = torch.where(is_medium_vertex, ph, sampling_pdf)
        surf_reject = ~is_medium_vertex & surf_reject

    dead = ((~lvalid) | (pmf <= 0) | surf_reject
            | torch.all(f == 0.0, dim=-1))
    active = active & ~dead
    # inactive lanes trace zero-length shadow rays (no kernel work)
    t_shadow = torch.where(active, t_shadow, 0.0)
    tr = None
    if volumetric:
        tr, blocked = transmittance(scene, meta, ref_p, sdir, t_shadow,
                                    medium, active, time)
        vis = ~blocked
    else:
        if occ is None:
            # the predicate's inputs are detached: its result is boolean,
            # and a recording bounce saves nothing for autograd in it
            occ = _occluded(scene, meta, ref_p, sdir.detach(),
                            t_shadow.detach(), rand_key=alpha_salt,
                            stats=occ_stats, time=time)
        vis = ~occ

    l_val = L.light_sample_L(scene, meta, lidx, ls, sdir)
    shape_pdf = L.light_sample_pdf(scene, meta, lidx, ls, ref_p, sdir)
    light_pdf = pmf * shape_pdf
    w2 = light_pdf * light_pdf
    w1 = sampling_pdf * sampling_pdf
    w_light = w2 / torch.clamp(w1 + w2, min=1e-18)
    contrib_delta = l_val * f / torch.clamp(pmf, min=1e-18)[:, None]
    contrib_mis = l_val * f * (w_light / torch.clamp(light_pdf,
                                                     min=1e-18))[:, None]
    contrib = torch.where(ls["is_delta"][:, None], contrib_delta,
                          torch.where((light_pdf > 0)[:, None], contrib_mis,
                                      0.0))
    if tr is not None:
        contrib = tr * contrib
    out = torch.where((active & vis)[:, None], contrib, 0.0)
    if want_occ:
        return out, (torch.zeros_like(active) if occ is None else occ)
    return out


# ---------------------------------------------------------------------------
# The bounce loop
# ---------------------------------------------------------------------------

def _make_bounce(scene, meta, cfg, px, py, time, sample_idx, n,
                 occ_stats=None, record: bool = False, replay=None):
    """One-bounce step for a bound lane set (time [n]: each lane's shutter
    time, used only on a moving scene).  `bounce(state, b)` advances
    every lane one bounce; b is an int or a per-lane [n] tensor (trace_regen,
    where each lane sits at its own depth).  occ_stats (a dict) accumulates
    the shadow predicate's "calls" and "restarts".

    record=True makes `bounce` return (state, aux), aux the traversal
    outputs {hit_t, hit_kind, hit_idx, hit_valid, occ}; replay=aux runs
    the shade math only, with those outputs in place of the closest-hit
    pass and the shadow predicate (no traversal, no kernel launch).
    Sampling and shading are deterministic, so a replay recomputes the
    recorded bounce exactly.  Media are refused in both modes (volpath's
    transmittance marches are traversals of their own)."""
    simple = cfg.integrator == "simple"
    volumetric = cfg.integrator == "volpath"
    if volumetric and (record or replay is not None):
        raise NotImplementedError("recording / replaying bounces do not "
                                  "support media (volpath)")
    media = volumetric and meta.n_media > 0
    s = cfg.sampler
    present = meta.mats_present

    def dim(b, off):
        return _DIM_BASE + b * _DIM_STRIDE + off

    def bounce(state, b):
        alive = state["alive"]
        o, d = state["o"], state["d"]
        tput = state["tput"]
        radiance = state["radiance"]
        n_rays = state["n_rays"] + alive.sum()

        if replay is not None:
            hit = dict(t=replay["hit_t"], kind=replay["hit_kind"],
                       idx=replay["hit_idx"], valid=replay["hit_valid"])
        else:
            # dead lanes get t_max = 0: they miss and cost the kernel nothing
            hit = _intersect(scene, meta, o, d,
                             torch.where(alive, BIG_F32, 0.0), time)
        it = make_interaction(scene, meta, o, d, hit, time=time)
        missed = alive & ~hit["valid"]

        # ---- escaped rays: infinite lights (MIS against BSDF sampling)
        for i in range(meta.n_inf):
            lid = scene["inf_idx"][i].expand(n)
            le = L.infinite_le(scene, meta, lid, d)
            lpdf = L.light_pmf(scene, meta, lid) * \
                L.infinite_light_mis_pdf(scene, meta, lid, d)
            pp = state["prev_pdf"]
            w = torch.where(state["spec"], 1.0,
                            torch.where(pp > 0, pp * pp / torch.clamp(
                                pp * pp + lpdf * lpdf, min=1e-18), 0.0))
            if simple:
                w = torch.ones_like(w)
            radiance = radiance + torch.where(missed[:, None],
                                              tput * le * w[:, None], 0.0)
        alive = alive & hit["valid"]

        # ---- participating medium segment: a scatter event inside the
        # medium before the surface hit, or the segment's transmittance
        if media:
            med = state["medium"]
            if meta.scene_medium >= 0:
                med = torch.where(med < 0, meta.scene_medium, med)
            in_medium = alive & (med >= 0)
            mi = torch.clamp(med, 0, scene["med_sigma_t"].shape[0] - 1)
            u_ch = sample_1d(s, px, py, sample_idx, dim(b, _D_MED_CHANNEL))
            u_dist = sample_1d(s, px, py, sample_idx, dim(b, _D_MED_DIST))
            scat, t_scat, w_med = medium_sample(
                scene["med_sigma_t"][mi], scene["med_sigma_s"][mi], hit["t"],
                u_ch, u_dist)
            tput = torch.where(in_medium[:, None], tput * w_med, tput)
            med_scatter = in_medium & scat
            state = dict(state, medium=med)

        # ---- per-bounce randoms
        uv_scatter = sample_2d(s, px, py, sample_idx, dim(b, _D_SCATTER_UV))
        uv_light = sample_2d(s, px, py, sample_idx, dim(b, _D_LIGHT_UV))
        u_scatter = sample_1d(s, px, py, sample_idx, dim(b, _D_SCATTER_U))
        u_select = sample_1d(s, px, py, sample_idx, dim(b, _D_LIGHT_SELECT))
        u_rr = sample_1d(s, px, py, sample_idx, dim(b, _D_RR))
        u_cell = rngmod.hash_float(px, py, sample_idx, dim(b, _D_ENV_CELL),
                                   s.seed)
        alpha_salt = rngmod.hash_u32(sample_idx, b, s.seed)

        mat = resolve_material(scene, meta, it)
        if volumetric:
            mi = torch.clamp(state["medium"], 0, scene["med_g"].shape[0] - 1)
            g_lanes = scene["med_g"][mi]
            vol = dict(medium=state["medium"], g_lanes=g_lanes,
                       volumetric=True)

        # ---- emitter hit
        surf = alive & ~med_scatter if media else alive
        emit_l = L.area_light_L(scene, meta, it["light_id"], it["n"],
                                it["uv"], d)
        has_emit = (surf & (it["light_id"] >= 0)
                    & torch.any(emit_l != 0.0, dim=-1))
        lpmf_hit = L.light_pmf(scene, meta,
                               torch.clamp(it["light_id"], 0,
                                           max(meta.n_lights - 1, 0)))
        lpdf_hit = lpmf_hit * L.area_light_hit_pdf(
            scene, meta, it["light_id"], o, it["p_raw"], it["n"], d)
        pp = state["prev_pdf"]
        w_emit = torch.where(state["spec"], 1.0,
                             torch.where(pp > 0, pp * pp / torch.clamp(
                                 pp * pp + lpdf_hit * lpdf_hit, min=1e-18),
                                 0.0))
        if simple:
            w_emit = torch.ones_like(w_emit)
        radiance = radiance + torch.where(has_emit[:, None],
                                          tput * emit_l * w_emit[:, None],
                                          0.0)

        # ---- medium scatter vertex: NEE with the phase function, the
        # medium's emission, and a phase-sampled direction
        if media:
            uv_phase = sample_2d(s, px, py, sample_idx, dim(b, _D_PHASE))
            scat_p = fma(t_scat[:, None], d, o)
            it_med = dict(it, p=scat_p, p_raw=scat_p)
            nee_med = sample_ld(scene, meta, cfg, d, it_med, mat, u_select,
                                uv_light, u_cell, alpha_salt, med_scatter,
                                occ_stats, time,
                                is_medium_vertex=torch.ones_like(med_scatter),
                                **vol)
            radiance = radiance + torch.where(med_scatter[:, None],
                                              tput * nee_med, 0.0)
            n_rays = n_rays + med_scatter.sum()
            radiance = radiance + torch.where(med_scatter[:, None],
                                              tput * scene["med_le"][mi], 0.0)
            new_dir_med, _ = hg_sample(d, g_lanes, uv_phase)

        boundary = surf & (it["mat_id"] < 0)       # material-less surface
        can_scatter = surf & (it["mat_id"] >= 0)
        if meta.has_alpha:
            # alpha transparency: a failed stochastic-blend or mask test
            # lets the ray pass through the surface as if it were not
            # there (handled below like a material-less boundary)
            mid_a = torch.clamp(it["mat_id"], 0,
                                scene["mat_type"].shape[0] - 1)
            mode_a = scene["mat_alpha_mode"][mid_a]
            cutoff_a = scene["mat_alpha_cutoff"][mid_a]
            atex = scene["mat_tex"][mid_a, 4]
            btex = scene["mat_tex"][mid_a, 0]
            a_val = texture_alpha(scene, torch.where(atex >= 0, atex, btex),
                                  it["uv"])
            if meta.mat_tex_present[4]:
                # a dedicated alpha texture reads channel 0
                a_val = torch.where(
                    atex >= 0, texture_eval(scene, atex, it["uv"])[:, 0],
                    a_val)
            u_alpha = sample_1d(s, px, py, sample_idx, dim(b, _D_ALPHA))
            solid = torch.where(mode_a == ALPHA_BLEND, u_alpha < a_val,
                                torch.where(mode_a == ALPHA_MASK,
                                            a_val > cutoff_a, True))
            see_through = can_scatter & ~solid
            boundary = boundary | see_through
            can_scatter = can_scatter & solid
        wi, f, pdf, flags, bvalid, new_origin = bsdf_sample(
            mat, d, it, u_scatter, uv_scatter, present=present)
        absorbed = can_scatter & ~bvalid
        scattered = can_scatter & bvalid
        new_spec = (flags & FLAG_SPECULAR) > 0

        # ---- NEE from the surface
        occ_rec = None
        if not simple:
            nee_active = scattered & ~new_spec
            vkw = dict(is_medium_vertex=torch.zeros_like(nee_active),
                       **vol) if volumetric else {}
            nee = sample_ld(scene, meta, cfg, d, it, mat, u_select, uv_light,
                            u_cell, alpha_salt, nee_active, occ_stats, time,
                            occ=None if replay is None else replay["occ"],
                            want_occ=record, **vkw)
            if record:
                nee, occ_rec = nee
            radiance = radiance + torch.where(nee_active[:, None],
                                              tput * nee, 0.0)
            n_rays = n_rays + nee_active.sum()
            _, pdf_mis = bsdf_eval_pdf(mat, d, it, wi, present=present)
            new_prev_pdf = torch.where(scattered & ~new_spec, pdf_mis,
                                       state["prev_pdf"])
        else:
            new_prev_pdf = state["prev_pdf"]

        # ---- throughput update
        ns = it["ns"]
        cos_wi = torch.abs(ns[:, 0] * wi[:, 0] + ns[:, 1] * wi[:, 1]
                           + ns[:, 2] * wi[:, 2])
        tput_new = tput * f * (cos_wi / torch.clamp(pdf, min=1e-18))[:, None]
        tput = torch.where(scattered[:, None], tput_new, tput)

        # ---- medium handoff: the medium on the side the ray goes on to
        if volumetric:
            transmissive = (flags & FLAG_TRANSMISSIVE) > 0
            med_next = torch.where(vdot(wi, it["n"]) < 0.0, it["med_id"], -1)
            carry = ~transmissive & (vdot(d, it["ns"]) <= 0.0)
            med_next = torch.where(carry, state["medium"], med_next)
            med_boundary = torch.where(vdot(d, it["n"]) < 0.0, it["med_id"],
                                       -1)
            medium = torch.where(scattered, med_next,
                                 torch.where(boundary, med_boundary,
                                             state["medium"]))
        else:
            medium = state["medium"]

        # ---- next ray state
        o_next = torch.where(scattered[:, None], new_origin,
                             torch.where(boundary[:, None], it["p_raw"], o))
        d_next = torch.where(scattered[:, None], wi, d)
        spec = torch.where(scattered, new_spec,
                           torch.where(boundary, not volumetric,
                                       state["spec"]))
        if media:       # a medium scatter overrides the surface's results
            o_next = torch.where(med_scatter[:, None], scat_p, o_next)
            d_next = torch.where(med_scatter[:, None], new_dir_med, d_next)
            spec = torch.where(med_scatter, False, spec)

        # ---- Russian roulette
        did_scatter = scattered | med_scatter if media else scattered
        rr_depth = state["rr_depth"] + did_scatter.to(torch.int64)
        rr_on = did_scatter & (rr_depth > cfg.rr_start)
        rr_prob = torch.clamp(torch.max(tput, dim=-1).values, max=0.95)
        rr_kill = rr_on & (u_rr >= rr_prob)
        tput = torch.where((rr_on & ~rr_kill)[:, None],
                           tput / torch.clamp(rr_prob, min=1e-18)[:, None],
                           tput)

        alive = alive & ~absorbed & ~rr_kill
        alive = alive & (did_scatter | boundary)
        alive = alive & (torch.sum(tput, dim=-1) > 0.0)
        out = dict(o=o_next, d=d_next, tput=tput, radiance=radiance,
                   prev_pdf=new_prev_pdf, spec=spec, alive=alive,
                   medium=medium, rr_depth=rr_depth, n_rays=n_rays,
                   t_hit=hit["t"])
        if record:
            return out, dict(hit_t=hit["t"], hit_kind=hit["kind"],
                             hit_idx=hit["idx"], hit_valid=hit["valid"],
                             occ=(torch.zeros_like(alive) if occ_rec is None
                                  else occ_rec))
        return out

    return bounce
