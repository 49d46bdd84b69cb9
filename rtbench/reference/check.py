"""The comparison that decides a run's `correct`.

The reference builds its own scene tables from the raw description (the
frozen builder, accel="brute") and judges what the window's timed path
produced, stage by stage, at the captured lanes (rtbench/capture.py):

- closest: each closest-hit answer of the traversal is a hit of the named
  primitive at the named distance, and no surface the ray meets is nearer
  except alpha-cutout surfaces that are transparent where the ray meets
  them (the reference's own scan, rtbench/reference/scan.py, and over
  run-time instances rtbench/reference/iscan.py);
- shadow: each shadow-predicate answer against the scan's, where the scan
  is unambiguous (no surface within a relative 1e-4 of the ray's end);
- shade: each captured bounce replayed by the frozen bounce math from
  the program's lane state and its (judged) traversal answers; the lane
  state after it is compared field by field;
- camera: the state of every sample at depth 0 against the camera worked
  out from the description (rtbench/reference/sensor.py);
- flush: the radiance a finished sample leaves in the item's output;
- film: the window's film against sensor.py's float64 splat of every
  item's per-sample output;
- counts: every queue entry of every item starts once and ends once.

What is independent of the port: the traversal answers (the scan), the
camera and the film (sensor.py, written from the formulas), the flush and
the counts (bookkeeping).  The bounce replay (`shade_bad_share`) and the
gradient (`loss_rel_err`, `grad_rel_err`) run a frozen copy of the port's
shade code (snap/): they catch a later change of what the port computes,
not a fault the port has today.

The program is followed step by step from its own state: the judged
answers and the captured lane state are the program's.  The start
(camera) and the stages between bounces (flush, film, counts) are checked
by themselves.  Limits: LIMITS, set in PERF.md from sound runs and the
lower-precision control.
"""
from __future__ import annotations

import numpy as np
import torch

from .scan import Scan, BIG
from .iscan import InstScan
from .snap.integrators.path import RenderConfig, _make_bounce
from .snap.core.rng import SamplerConfig
from .snap.core.filters import mitchell
from .snap.sensor.camera import film_position
from .snap.sensor import film as snapfilm
from . import sensor
from .snap.scene.builder import SceneBuilder
from .snap.scene.textures import texture_alpha
from .snap.scene.types import ALPHA_MASK, ALPHA_OPAQUE, SHAPE_TRI, \
    SHAPE_SPH, SHAPE_QUAD, SHAPE_ITRI

# relative distance tolerance of a traversal answer
T_TOL = 1e-4
# a bounce whose state after it departs from the replay by more than this
# (relative, field by field) is a bad bounce
SHADE_TOL = 1e-3

# name -> limit; a number above its limit makes the run incorrect.  Each
# limit lies between the highest reading of sound runs and the lowest of
# the bfloat16 control (PERF.md, section 2, gives both)
LIMITS = {
    "closest_bad_share": 0.05,
    "shadow_bad_share": 0.03,
    "shade_bad_share": 0.05,
    "camera_max_err": 1e-4,
    "flush_bad_share": 0.05,
    "film_max_rel_err": 5e-4,
    "starts_missing": 0,
    "ends_missing": 0,
    # differentiable mixes: the chosen item's loss and gradients
    "loss_rel_err": 1e-3,
    "grad_rel_err": 1e-3,
}


def build_reference(desc, device):
    from ..scenedesc import replay
    b = replay(desc, SceneBuilder())
    return b.build(accel="brute", device=device)


def render_config(traffic, seed):
    return RenderConfig(spp=1, max_depth=int(traffic["max_depth"]),
                        integrator=traffic["integrator"],
                        sampler=SamplerConfig(
                            kind=traffic["sampler"]["kind"],
                            x_samples=traffic["sampler"]["x_samples"],
                            y_samples=traffic["sampler"]["y_samples"],
                            seed=seed),
                        filter=mitchell(), rr_start=int(traffic["rr_start"]),
                        rays_per_batch=int(traffic["lanes"]),
                        regenerate=True)


def make_scan(scene, meta, dtype=torch.float32):
    """The reference's traversal of the scene: world triangles, spheres and
    quads (scan.py) and, where the scene has them, run-time instances
    (iscan.py, as `.inst`)."""
    return Scan(scene, meta.n_tri, meta.n_sph, meta.n_quad, dtype=dtype,
                inst=InstScan(scene, dtype=dtype) if meta.n_inst else None)


def _solid(scene, prop, tri_uv, u, v):
    """Does the surface stop a ray at barycentrics (u, v) of the triangles
    with rows prop / tri_uv (world or object-space): opaque materials
    always, alpha-mask ones where the texture's alpha exceeds the cutoff.
    Blended alpha is stochastic: never counted."""
    mat = prop[:, 0].long()
    mat_c = mat.clamp(0, scene["mat_type"].shape[0] - 1)
    mode = torch.where(mat >= 0, scene["mat_alpha_mode"][mat_c].long(),
                       ALPHA_OPAQUE)
    solid = mode == ALPHA_OPAQUE
    is_mask = mode == ALPHA_MASK
    if bool(is_mask.any()):
        m = mat_c[is_mask]
        uv3 = tri_uv[is_mask]
        uu, vv = u[is_mask, None], v[is_mask, None]
        uv = (1 - uu - vv) * uv3[:, 0] + uu * uv3[:, 1] + vv * uv3[:, 2]
        atex = scene["mat_tex"][m, 4]
        tid = torch.where(atex >= 0, atex, scene["mat_tex"][m, 0])
        a = texture_alpha(scene, tid, uv)
        solid[is_mask] = a > scene["mat_alpha_cutoff"][m]
    return solid


def nearest_solid(scene, scan, o, d, t_max):
    """Per ray, the distance of the nearest surface that stops it within
    t_max (BIG: none)."""
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    ray, tri, t, u, v = scan.tri_hits(o, d, t_max)
    if ray.numel():
        ok = _solid(scene, scene["tri_prop"][tri], scene["tri_uv"][tri], u, v)
        best.scatter_reduce_(0, ray[ok], t[ok], reduce="amin")
    if scan.inst is not None:
        ray, _, otri, t, u, v = scan.inst.hits(o, d, t_max)
        if ray.numel():
            ok = _solid(scene, scene["otri_prop"][otri],
                        scene["otri_uv"][otri], u, v)
            best.scatter_reduce_(0, ray[ok], t[ok], reduce="amin")
    (ts, vs), (tq, vq) = scan.analytic_hits(o, d, t_max)
    for tt, vv in ((ts, vs), (tq, vq)):
        if tt.numel():
            best = torch.minimum(best, torch.where(vv, tt, BIG).amin(-1))
    return best


def prim_distance(scan, scene, o, d, kind, idx):
    """The distance at which each ray meets its named primitive (BIG if it
    does not)."""
    t = torch.full(kind.shape, BIG, dtype=torch.float32, device=o.device)
    for k in (SHAPE_TRI, SHAPE_SPH, SHAPE_QUAD, SHAPE_ITRI):
        m = kind == k
        if not bool(m.any()):
            continue
        i = idx[m].long()
        if k == SHAPE_ITRI:
            if scan.inst is None:       # no instance to name: no hit
                continue
            tt, ok = scan.inst.named_hit(o[m], d[m], i)
        elif k == SHAPE_TRI:
            tt, ok, _, _ = scan.tri_hit(o[m], d[m],
                                        scene["tri_v"][i].to(scan.dtype))
        elif k == SHAPE_SPH:
            tt, ok = scan.sph_hit(o[m], d[m], scene["sph_c"][i],
                                  scene["sph_r"][i])
        else:
            tt, ok = scan.quad_hit(o[m], d[m], scene["quad_q"][i],
                                   scene["quad_u"][i], scene["quad_v"][i],
                                   scene["quad_n"][i])
        t[m] = torch.where(ok, tt.float(), BIG)
    return t


def closest_bad(scene, scan, o, d, t, kind, idx, valid):
    """Bool per ray: the program's closest-hit answer is wrong."""
    tol = T_TOL * torch.clamp(t, min=1.0)
    reach = torch.where(valid, t + tol, torch.full_like(t, BIG))
    near = nearest_solid(scene, scan, o, d, reach)
    t_named = prim_distance(scan, scene, o, d, kind, idx)
    named_ok = (t_named - t).abs() <= tol
    return torch.where(valid, ~named_ok | (near < t - tol), near < BIG)


def shadow_bad(scene, scan, o, d, t_max, occ):
    tol = T_TOL * torch.clamp(t_max, min=1.0)
    near = nearest_solid(scene, scan, o, d, t_max + tol)
    sure_occ = near < t_max - tol
    sure_free = near >= BIG
    return (occ & sure_free) | (~occ & sure_occ)


def _rel(a, b, floor):
    return ((a - b).abs() / torch.clamp(b.abs(), min=floor)).reshape(
        a.shape[0], -1).amax(-1)


def replay_bounces(scene, meta, cfg, g, dtype=None):
    """The frozen bounce over the captured rows g (a dict of tensors):
    the lane state after each.  dtype=torch.bfloat16: inputs, tables and
    results rounded to it (the lower-precision control)."""
    def rnd(x):
        if dtype is None or not torch.is_floating_point(x):
            return x
        return x.to(dtype).float()
    if dtype is not None:
        scene = {k: rnd(v) if torch.is_tensor(v) else v
                 for k, v in scene.items()}
    n = g["px"].shape[0]
    state = {k: rnd(g["in_" + k]) for k in ("o", "d", "tput", "radiance",
                                            "prev_pdf")}
    state.update(spec=g["in_spec"], alive=g["in_alive"],
                 medium=g["in_medium"], rr_depth=g["in_rr_depth"],
                 n_rays=torch.zeros((), dtype=torch.int64,
                                    device=g["px"].device))
    aux = dict(hit_t=rnd(g["hit_t"]), hit_kind=g["hit_kind"],
               hit_idx=g["hit_idx"], hit_valid=g["hit_valid"], occ=g["occ"])
    bounce = _make_bounce(scene, meta, cfg, g["px"], g["py"], None,
                          g["sidx"], n, replay=aux)
    out = bounce(state, g["b"])
    return {k: rnd(v) if torch.is_tensor(v) else v for k, v in out.items()}


def shade_bad(g, ref):
    """Bool per captured bounce: the program's state after the bounce
    departs from the replay's."""
    err = torch.zeros(g["px"].shape[0], device=g["px"].device)
    for k, floor in (("o", 1.0), ("d", 1.0), ("tput", 1e-3),
                     ("radiance", 1e-3), ("prev_pdf", 1e-3)):
        err = torch.maximum(err, _rel(g["out_" + k].float(),
                                      ref[k].float(), floor))
    err = torch.nan_to_num(err, nan=1e30)
    bad = err > SHADE_TOL
    for k in ("spec", "alive", "rr_depth"):
        bad = bad | (g["out_" + k] != ref[k])
    return bad


def run_checks(desc, traffic, seed, cap, films, device, control=None,
               grad=None):
    """All numbers compared, as {name: value}.  With `control` ("bf16")
    the numbers are the control's: the reference computed in bfloat16 put
    in the program's place, judged by the same limits.  films: [(film,
    [item numbers splatted into it])]; grad (differentiable mixes):
    dict(item, loss, grads, target, names) of the item the seed chose."""
    scene, fcam, meta = build_reference(desc, device)
    cam = sensor.camera_of(desc)
    sampler = dict(traffic["sampler"], seed=int(seed))
    cfg = render_config(traffic, seed)
    g = cap.gathered(device)
    if not g:
        # nothing of the timed path was captured: nothing could be judged
        return {k: (1.0 if isinstance(v, float) else 1)
                for k, v in LIMITS.items()}
    scan = make_scan(scene, meta)
    ref = replay_bounces(scene, meta, cfg, g)
    items = [(o, p, off, w) for _, o, p, off, w in cap.items]
    if control == "bf16":
        g, items, films = _bf16_program(scene, meta, cfg, g, items, films)
        res = _numbers(scene, cam, sampler, cfg, scan, g, ref, items, films,
                       device, rnd=_bf16)
    else:
        res = _numbers(scene, cam, sampler, cfg, scan, g, ref, items, films,
                       device, rnd=None)
    q_total = sum(out.shape[0] for out, _, _, _ in items)
    counts = cap.counts.tolist() if cap.counts is not None else [0, 0]
    res["starts_missing"] = int(abs(q_total - counts[0]))
    res["ends_missing"] = int(abs(q_total - counts[1]))
    res["bounces_checked"] = int(g["in_alive"].sum())
    res["shadow_rays_checked"] = int((g["sh_tmax"] > 0).sum())
    res["instanced_hits_checked"] = _instanced_checked(scan, g)
    if grad is not None:
        out, pix, off, _ = items[grad["item"]]
        recs = cap.drains[grad["item"]]
        loss_r, grads_r = reference_grad(scene, meta, fcam, cfg, recs, pix,
                                         off, grad["target"], grad["names"])
        if control == "bf16":
            loss_p, grads_p = reference_grad(scene, meta, fcam, cfg, recs,
                                             pix, off, grad["target"],
                                             grad["names"],
                                             dtype=torch.bfloat16)
        else:
            loss_p, grads_p = grad["loss"], grad["grads"]
        res.update(grad_numbers(loss_p, grads_p, loss_r, grads_r))
    return res


def _instanced_checked(scan, g):
    """The closest-hit answers of kind SHAPE_ITRI judged, and the shadow
    rays judged whose scan entered an instance's box."""
    if scan.inst is None:
        return 0
    alive = g["in_alive"] & g["hit_valid"]
    sh = g["sh_tmax"] > 0
    tol = T_TOL * torch.clamp(g["sh_tmax"][sh], min=1.0)
    return int((alive & (g["hit_kind"] == SHAPE_ITRI)).sum()) + int(
        scan.inst.entered_any(g["sh_o"][sh], g["sh_d"][sh],
                              g["sh_tmax"][sh] + tol).sum())


def _bf16(x):
    """float64 / float32 values rounded to bfloat16 (NumPy or torch)."""
    if torch.is_tensor(x):
        return x.to(torch.bfloat16).to(x.dtype)
    return torch.as_tensor(np.array(x, np.float64)).to(
        torch.bfloat16).double().numpy()


def _numbers(scene, cam, sampler, cfg, scan, g, ref, items, films, device,
             rnd=None):
    """rnd: the rounding of the lower-precision control's camera (None:
    the program's own camera state is judged)."""
    res = {}
    alive = g["in_alive"]
    cb = closest_bad(scene, scan, g["ray_o"][alive], g["ray_d"][alive],
                     g["hit_t"][alive], g["hit_kind"][alive],
                     g["hit_idx"][alive], g["hit_valid"][alive])
    res["closest_bad_share"] = float(cb.float().mean()) if cb.numel() else 0.0
    sh = g["sh_tmax"] > 0
    sb = shadow_bad(scene, scan, g["sh_o"][sh], g["sh_d"][sh],
                    g["sh_tmax"][sh], g["occ"][sh])
    res["shadow_bad_share"] = float(sb.float().mean()) if sb.numel() else 0.0
    bad = shade_bad(g, ref)[alive]
    res["shade_bad_share"] = float(bad.float().mean()) if bad.numel() else 0.0
    # the start: samples at depth 0, against the camera of the description
    fresh = alive & (g["b"] == 0)
    if bool(fresh.any()):
        px, py, sidx = (g[k][fresh].cpu().numpy() for k in ("px", "py",
                                                             "sidx"))
        o, d = sensor.camera_rays(cam, sampler, px, py, sidx)
        if rnd is None:
            po = g["in_o"][fresh].double().cpu().numpy()
            pd = g["in_d"][fresh].double().cpu().numpy()
        else:
            po, pd = sensor.camera_rays(cam, sampler, px, py, sidx, rnd=rnd)
        res["camera_max_err"] = float(np.maximum(
            np.abs(po - o).max(-1) / np.maximum(np.abs(o).max(-1), 1.0),
            np.abs(pd - d).max(-1)).max())
    else:
        res["camera_max_err"] = 0.0
    res["flush_bad_share"] = _flush_bad(items, g, cam, cfg, device)
    res["film_max_rel_err"] = max(_film_err([items[i] for i in idx], film,
                                            cam, sampler, device)
                                  for film, idx in films)
    return res


def _bf16_program(scene, meta, cfg, g, items, films):
    """The control: what a program computing in bfloat16 would hand over
    at the same lanes (traversal on tables and rays rounded to bfloat16,
    the bounce, the camera and the splat on inputs rounded to it; the
    instanced scan too: object triangles, inverse maps and rays).
    Returns (g, items, films) for _numbers: the float32 replay stays the
    reference."""
    lo = make_scan(scene, meta, dtype=torch.bfloat16)
    g = dict(g)
    near = nearest_solid(scene, lo, g["ray_o"], g["ray_d"],
                         torch.full_like(g["hit_t"], BIG))
    g["hit_valid"] = near < BIG
    g["hit_t"] = torch.where(near < BIG, near, g["hit_t"])
    sh = nearest_solid(scene, lo, g["sh_o"], g["sh_d"], g["sh_tmax"])
    g["occ"] = (sh < g["sh_tmax"]) & (g["sh_tmax"] > 0)
    low = replay_bounces(scene, meta, cfg, g, dtype=torch.bfloat16)
    for k in ("o", "d", "tput", "radiance", "prev_pdf", "spec", "alive",
              "rr_depth"):
        g["out_" + k] = low[k]
    items = [(_bf16(out), p, off, w) for out, p, off, w in items]
    films = [({k: _bf16(v) for k, v in film.items()}, idx)
             for film, idx in films]
    return g, items, films


def _flush_bad(items, g, cam, cfg, device):
    w = cam["resolution"][0]
    ended = g["in_alive"] & ~(g["out_alive"]
                              & (g["b"] + 1 < cfg.max_depth))
    if not bool(ended.any()):
        return 0.0
    bad = []
    for item, (out, pixel_idx, offset, waves) in enumerate(items):
        m = ended & (g["item"] == item)
        if not bool(m.any()):
            continue
        pix = (g["py"][m] * w + g["px"][m]).long()
        pos = torch.full((cam["resolution"][0] * cam["resolution"][1],), -1,
                         dtype=torch.int64, device=device)
        pos[pixel_idx.to(device)] = torch.arange(pixel_idx.shape[0],
                                                 device=device)
        qi = (g["sidx"][m].long() - offset) * pixel_idx.shape[0] + pos[pix]
        rad = g["out_radiance"][m]
        rad = torch.where(torch.isfinite(rad), rad, 0.0)
        got = out.to(device)[qi.clamp(0, out.shape[0] - 1)]
        err = _rel(got, rad, 1e-6)
        bad.append((err > 1e-6) | (pos[pix] < 0))
    if not bad:
        return 0.0
    return float(torch.cat(bad).float().mean())


def _film_err(items, film, cam, sampler, device):
    """The film's largest gap to sensor.py's float64 splat of the items'
    per-sample outputs, relative to the largest value (colour and weight
    apart)."""
    w = cam["resolution"][0]
    ref = sensor.Film(cam["resolution"], device=device)
    for out, pixel_idx, offset, waves in items:
        pix = pixel_idx.cpu().numpy()
        k = pix.shape[0]
        out = out.double().cpu()
        out = torch.where(torch.isfinite(out), out, 0.0).numpy()
        for s in range(waves):
            p = sensor.film_position(sampler, pix % w, pix // w,
                                     np.full_like(pix, offset + s))
            ref.splat(p, out[s * k:(s + 1) * k])
    scale = max(float(ref.rgb.abs().max()), 1e-6)
    wscale = max(float(ref.weight.abs().max()), 1e-6)
    return max(float((film["rgb"].to(device).double() - ref.rgb).abs().max())
               / scale,
               float((film["weight"].to(device).double()
                      - ref.weight).abs().max()) / wscale)


def reference_grad(scene, meta, cam, cfg, records, pixel_idx, offset,
                   target, names, dtype=None):
    """The loss of one differentiable work item and its gradient in the
    parameter arrays `names`, by the frozen bounce run forward under
    autograd over the program's recorded drain: the recorded traversal
    answers, schedule and lane geometry, the differentiable carry (tput,
    prev_pdf, radiance) the reference's own.  Then the frozen splat and
    the mean squared error against `target` over the item's pixels.
    dtype=torch.bfloat16: tables and carry rounded to it (the control)."""
    def rnd(x):
        return x if dtype is None else x.to(dtype).float()
    leaves = {k: rnd(scene[k].detach()).requires_grad_(True) for k in names}
    sc = {k: (rnd(v) if torch.is_tensor(v) and v.is_floating_point()
              else v) for k, v in scene.items()}
    sc.update(leaves)
    dev = pixel_idx.device
    w = cam["resolution"][0]
    n_pix = pixel_idx.shape[0]
    q_total = n_pix
    out = torch.zeros((q_total, 3), device=dev)
    tput = prev_pdf = radiance = None
    with torch.enable_grad():
        for rec in records:
            qi = rec["qi"].long()
            k = qi.shape[0]
            if tput is None:
                tput = torch.ones((k, 3), device=dev)
                prev_pdf = torch.ones((k,), device=dev)
                radiance = torch.zeros((k, 3), device=dev)
            pix = pixel_idx[qi.clamp(0, q_total - 1) % n_pix]
            sidx = offset + qi // n_pix
            aux = dict(hit_t=rec["hit_t"], hit_kind=rec["hit_kind"].long(),
                       hit_idx=rec["hit_idx"].long(),
                       hit_valid=rec["hit_valid"], occ=rec["occ"])
            bounce = _make_bounce(sc, meta, cfg, pix % w, pix // w, None,
                                  sidx, k, replay=aux)
            b = rec["b"].long()
            st = bounce(dict(o=rec["o"], d=rec["d"], tput=rnd(tput),
                             radiance=rnd(radiance), prev_pdf=rnd(prev_pdf),
                             spec=rec["spec"], alive=rec["alive"],
                             medium=torch.full((k,), meta.camera_medium,
                                               dtype=torch.int64,
                                               device=dev),
                             rr_depth=rec["rr_depth"].long(),
                             n_rays=torch.zeros((), dtype=torch.int64,
                                                device=dev)), b)
            alive = st["alive"] & (b + 1 < cfg.max_depth)
            finished = rec["alive"] & ~alive
            rad = torch.where(rec["rad_ok"], st["radiance"], 0.0)
            out = out.index_add(0, qi.clamp(0, q_total - 1),
                                torch.where(finished[:, None], rad, 0.0))
            ranks = torch.cumsum(finished.long(), 0) - 1
            take = (finished & (rec["head"] + ranks < q_total))[:, None]
            tput = torch.where(take, 1.0, st["tput"])
            prev_pdf = torch.where(take[:, 0], 1.0, st["prev_pdf"])
            radiance = torch.where(take, 0.0, st["radiance"])
        film = snapfilm.new_film(cam["resolution"], device=dev)
        p = film_position(cfg.sampler, pixel_idx % w, pixel_idx // w,
                          torch.full_like(pixel_idx, offset))
        film = snapfilm.splat(film, cfg.filter, cam["resolution"], p, out)
        loss = ((film["rgb"][pixel_idx] - target[pixel_idx]) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
    grads = [torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, grads)]
    return float(loss.detach()), dict(zip(names, grads))


def grad_numbers(loss_p, grads_p, loss_r, grads_r):
    """The loss's relative gap, and the worst parameter array's
    |g_program - g_reference| / |g_reference| (norms over the array)."""
    worst = 0.0
    for k, gr in grads_r.items():
        gp = grads_p.get(k)
        nr = float(gr.norm())
        if gp is None:
            worst = max(worst, 1.0 if nr > 0 else 0.0)
            continue
        worst = max(worst, float((gp.float() - gr).norm()) / max(nr, 1e-30))
    return dict(loss_rel_err=abs(loss_p - loss_r) / max(abs(loss_r), 1e-30),
                grad_rel_err=worst)
