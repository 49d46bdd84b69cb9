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
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device, to_device
from ..core.math import BIG_F32, SHADOW_EPS
from ..core import rng as rngmod
from ..core.rng import SamplerConfig, sample_1d, sample_2d
from ..core.bsdf import (bsdf_sample, bsdf_eval_pdf, material_lanes,
                         FLAG_SPECULAR, FLAG_TRANSMISSIVE)
from ..core.filters import FilterConfig, mitchell
from ..core.math import fma, vdot, vdot_k, offset_ray
from ..core.medium import medium_sample, medium_tr
from ..core.phase import hg_pdf, hg_sample
from ..scene.intersect import _intersect, make_interaction, _occluded
from ..scene import lights as L
from ..scene.textures import texture_alpha, texture_eval
from ..scene.types import ALPHA_BLEND, ALPHA_MASK

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
    if meta.n_env or meta.has_emissive_tex:
        raise NotImplementedError(
            "scene uses features not ported yet (environment or emissive "
            "textures)")
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


def _fresh_state(o, d, n, medium):
    """Camera-ray lane state; medium: the camera's medium id."""
    dev = o.device
    return dict(o=o, d=d,
                tput=torch.ones((n, 3), dtype=torch.float32, device=dev),
                radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                prev_pdf=torch.ones((n,), dtype=torch.float32, device=dev),
                spec=torch.ones((n,), dtype=torch.bool, device=dev),
                alive=torch.ones((n,), dtype=torch.bool, device=dev),
                medium=torch.full((n,), medium, dtype=torch.int64, device=dev),
                rr_depth=torch.zeros((n,), dtype=torch.int64, device=dev),
                n_rays=torch.zeros((), dtype=torch.int64, device=dev))


def _gather(v, take):
    """Rows `take` of a per-lane tensor; scalars and None pass."""
    return v[take] if isinstance(v, torch.Tensor) and v.dim() else v


def _checkpointed_bounce(make_bounce):
    """The scan form's bounce under torch.utils.checkpoint: the forward
    runs the recording bounce and keeps its traversal outputs; the
    backward's recomputation replays the shade math on them, so it
    launches no traversal kernel (the counterpart of the reference's
    remat policy that saves the values named "traversal")."""
    def step(state, b):
        kept = {}

        def run(st):
            if "aux" in kept:
                return make_bounce(replay=kept["aux"])(st, b)
            out, kept["aux"] = make_bounce(record=True)(st, b)
            return out
        return checkpoint(run, state, use_reentrant=False)
    return step


def _trace(scene, meta, cfg, origin, direction, time, px, py, sample_idx,
           with_stats=False):
    _check_cfg(cfg, meta)
    n = origin.shape[0]
    state = _fresh_state(origin, direction, n, meta.camera_medium)
    time = time if meta.has_motion else None

    def bounce_for(take=None, **kw):
        """The bounce of every lane, or of the lanes `take` (compaction)."""
        if take is None:
            return _make_bounce(scene, meta, cfg, px, py, time, sample_idx,
                                n, **kw)
        return _make_bounce(scene, meta, cfg, px[take], py[take],
                            _gather(time, take), _gather(sample_idx, take),
                            take.shape[0], **kw)

    def step_for(take=None):
        if not (cfg.differentiable and cfg.remat):
            return bounce_for(take)
        if cfg.integrator == "volpath":
            # volpath's marches are traversals a replay cannot inject:
            # its backward recomputes the whole bounce
            bounce = bounce_for(take)
            return lambda st, b: checkpoint(bounce, st, b,
                                            use_reentrant=False)
        return _checkpointed_bounce(lambda **kw: bounce_for(take, **kw))

    def run(state, step, b0, b1):
        """Bounces b0 .. b1-1: all of them in the scan form, until every
        lane is dead in the forward form (one host sync per bounce, the
        .item() below).  Returns (state, the next bounce index)."""
        b = b0
        while b < b1 and (cfg.differentiable
                          or bool(state["alive"].any().item())):
            state = step(state, b)
            b += 1
        return state, b

    compact = (cfg.compact_after is not None
               and cfg.compact_after < cfg.max_depth and n >= 4096)
    state, b = run(state, step_for(), 0,
                   cfg.compact_after if compact else cfg.max_depth)
    if compact:
        # tail compaction: the (<= cap) surviving lanes, live first in a
        # stable order, continue in a quarter-width batch and their radiance
        # is scattered back; the RNG is keyed on (pixel, sample, bounce),
        # so the result is the full-width one (gather and scatter are
        # linear: gradients route back exactly)
        cap = max(1024, -(-(n // 4) // 1024) * 1024)
        live = state["alive"]
        if int(live.sum().item()) <= cap:
            take = torch.argsort((~live).to(torch.int8), stable=True)[:cap]
            sub = {k: _gather(v, take) for k, v in state.items()}
            sub, _ = run(sub, step_for(take), b, cfg.max_depth)
            state = dict(state, n_rays=sub["n_rays"],
                         radiance=state["radiance"].index_put(
                             (take,), sub["radiance"]))
        else:
            state, _ = run(state, step_for(), b, cfg.max_depth)
    if with_stats:
        return state["radiance"], dict(n_rays=state["n_rays"])
    return state["radiance"]


def trace(scene, cam, meta, cfg: RenderConfig, origin, direction, time,
          px, py, sample_idx, with_stats: bool = False, device=None):
    """Estimate Li for a batch of camera rays ([N,3] origin/direction,
    [N] pixel coordinates and sample indices).  Returns radiance [N,3];
    with_stats adds {"n_rays": traced rays (closest + shadow)}.  Runs on
    the GPU unless device="cpu"."""
    dev = resolve_device(device)
    return _trace(to_device(scene, dev), meta, cfg, origin.to(dev),
                  direction.to(dev),
                  None if time is None else torch.as_tensor(time).to(dev),
                  px.to(dev), py.to(dev),
                  torch.as_tensor(sample_idx).to(dev), with_stats)


# ---------------------------------------------------------------------------
# Persistent wavefront (ray regeneration)
# ---------------------------------------------------------------------------

def _queue_entries(cam, cfg, pixel_idx, sample_offset, qi):
    """Camera state (px, py, sample index, origin, direction, time) of the
    regeneration queue's entries `qi`: entry q is sample sample_offset +
    q // n_pixels of pixel pixel_idx[q % n_pixels]."""
    from ..sensor.camera import camera_lanes
    n_pix = pixel_idx.shape[0]
    w = cam["resolution"][0]
    pix = pixel_idx[qi % n_pix]
    px = pix % w
    py = pix // w
    sidx = int(sample_offset) + qi // n_pix
    o, d, tme, _ = camera_lanes(cam, cfg.sampler, px, py, sidx)
    return px, py, sidx, o, d, tme


def _trace_regen(scene, cam, meta, cfg, pixel_idx, waves, sample_offset,
                 lanes=None, with_stats=False, records=None):
    """The regenerating tracer (trace_regen's docstring).  records, a list,
    makes it the recording forward of regen_diff.trace_regen_diff: each
    iteration appends its inputs, its schedule and the traversal outputs of
    its bounce (_make_bounce(record=True))."""
    _check_cfg(cfg, meta)
    dev = pixel_idx.device
    n_pix = pixel_idx.shape[0]
    q_total = n_pix * waves
    k = min(lanes, q_total) if lanes else n_pix

    def fresh(qi):
        """Camera state for queue entries `qi` (stale lanes give garbage
        that callers mask)."""
        return _queue_entries(cam, cfg, pixel_idx, sample_offset, qi)

    motion = meta.has_motion
    qi = torch.arange(k, dtype=torch.int64, device=dev)
    px, py, sidx, o0, d0, tme = fresh(qi)
    st = _fresh_state(o0, d0, k, meta.camera_medium)
    head = torch.tensor(k, dtype=torch.int64, device=dev)
    b = torch.zeros((k,), dtype=torch.int64, device=dev)
    out = torch.zeros((q_total, 3), dtype=torch.float32, device=dev)
    occ_stats = {} if with_stats else None
    iterations = 0
    deep = torch.zeros((2,), dtype=torch.int64, device=dev)

    # data-dependent loop: one host sync per iteration (the .item() below)
    while bool(st["alive"].any().item()):
        bounce = _make_bounce(scene, meta, cfg, px, py,
                              tme if motion else None, sidx, k, occ_stats,
                              record=records is not None)
        prev_alive = st["alive"]
        if records is None:
            st = bounce(st, b)
        else:
            rec = _record(st, qi, b, head)
            st, aux = bounce(st, b)
            rec.update(_record_aux(aux), rad_ok=torch.isfinite(st["radiance"]))
            records.append(rec)
        if with_stats:
            iterations += 1
            is_deep = prev_alive & (b >= _DEEP_BOUNCE)
            deep += torch.stack([is_deep.sum(), (
                is_deep & (st["t_hit"] < _REHIT_T)).sum()])
        b = b + 1
        alive = st["alive"] & (b < cfg.max_depth)
        # flush every sample once, the iteration its path ends
        finished = prev_alive & ~alive
        rad = torch.where(torch.isfinite(st["radiance"]), st["radiance"], 0.0)
        # qi < q_total always; clamped so a CUDA scatter can never fault
        out.index_add_(0, torch.clamp(qi, 0, q_total - 1),
                       torch.where(finished[:, None], rad, 0.0))

        # refill finished lanes from the queue head, in lane order
        ranks = torch.cumsum(finished.to(torch.int64), 0) - 1
        cand = head + ranks
        take = finished & (cand < q_total)
        qi = torch.where(take, cand, qi)
        head = torch.clamp(head + finished.sum(), max=q_total)
        pxn, pyn, sidxn, on, dn, tmen = fresh(qi)
        tk = take[:, None]
        st = dict(
            o=torch.where(tk, on, st["o"]),
            d=torch.where(tk, dn, st["d"]),
            tput=torch.where(tk, 1.0, st["tput"]),
            radiance=torch.where(tk, 0.0, st["radiance"]),
            prev_pdf=torch.where(take, 1.0, st["prev_pdf"]),
            spec=torch.where(take, True, st["spec"]),
            alive=alive | take,
            medium=torch.where(take, meta.camera_medium, st["medium"]),
            rr_depth=torch.where(take, 0, st["rr_depth"]),
            n_rays=st["n_rays"])
        b = torch.where(take, 0, b)
        px = torch.where(take, pxn, px)
        py = torch.where(take, pyn, py)
        sidx = torch.where(take, sidxn, sidx)
        tme = torch.where(take, tmen, tme)
    if with_stats:
        return out, dict(n_rays=st["n_rays"],
                         occluded_calls=occ_stats.get("calls", 0),
                         chain_restarts=occ_stats.get("restarts", 0),
                         iterations=iterations, deep_bounces=deep[0],
                         deep_rehits=deep[1])
    return out


def _record(st, qi, b, head):
    """An iteration's inputs and schedule, in the narrowest dtypes that hold
    them (the recording forward keeps one per iteration)."""
    return dict(o=st["o"], d=st["d"], tput=st["tput"],
                prev_pdf=st["prev_pdf"], spec=st["spec"], alive=st["alive"],
                rr_depth=st["rr_depth"].to(torch.int16),
                qi=qi.to(torch.int32), b=b.to(torch.int16), head=head)


def _record_aux(aux):
    return dict(hit_t=aux["hit_t"], hit_kind=aux["hit_kind"].to(torch.int8),
                hit_idx=aux["hit_idx"].to(torch.int32),
                hit_valid=aux["hit_valid"], occ=aux["occ"])


def trace_regen(scene, cam, meta, cfg: RenderConfig, pixel_idx, waves: int,
                sample_offset, lanes: int | None = None,
                with_stats: bool = False, device=None):
    """Persistent-wavefront estimator: a queue of `waves` consecutive sample
    indices for each entry of `pixel_idx` is drained by `lanes` lanes; a
    lane whose path ends flushes its radiance and takes the next queue
    entry in the same iteration.  Each sample's radiance is a pure function
    of (pixel, sample, per-sample bounce), so the result matches `trace`
    to float precision.  Returns radiance [waves * n_pixels, 3], wave-major
    (entry s * n_pixels + i is sample sample_offset + s of pixel_idx[i]).
    Runs on the GPU unless device="cpu"."""
    dev = resolve_device(device)
    return _trace_regen(to_device(scene, dev), to_device(cam, dev), meta,
                        cfg, pixel_idx.to(dev), waves, sample_offset, lanes,
                        with_stats)
