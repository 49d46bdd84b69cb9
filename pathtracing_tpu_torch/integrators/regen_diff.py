"""Differentiable persistent wavefront (counterpart of
pathtracing_tpu/integrators/regen_diff.py).

The regenerating tracer (path.trace_regen) is the fastest forward form, but
its data-dependent loop keeps no autograd graph worth having: every
iteration's shade math would stay alive until the backward pass.  So
`trace_regen_diff` is a torch.autograd.Function:

  * forward: ONE recording run of the regenerating loop itself
    (path._trace_regen(records=...)), which keeps per iteration the
    bounce's inputs (o, d, tput, prev_pdf, spec, alive, rr_depth), its
    schedule (queue entry qi, bounce index b, queue head), the traversal
    outputs (closest hit, shadow visibility) and the radiance finiteness
    gate.  It launches the same kernels in the same order as trace_regen,
    so its radiance is trace_regen's.
  * backward: a reverse loop over the recorded iterations.  Each step
    replays that iteration's shade math on the recorded traversal outputs
    (path._make_bounce(replay=...): no traversal, no kernel launch) under
    autograd and pulls the carry cotangents (tput, radiance, prev_pdf) and
    the flushed radiance's cotangent back with torch.autograd.grad,
    accumulating the scene parameters' gradients.  Refills reset the carry
    to constants, so gradient chains end at sample boundaries.

The gradients are the scan form's (the detached-sampling estimator:
sampling decisions and geometry are detached, so the only differentiable
state carried between iterations is tput, radiance and prev_pdf).
Radiance enters each iteration linearly, so the replay starts it at zero;
the flush gate uses the recorded finiteness.

Media (volpath) are refused: its transmittance marches are traversals the
recording does not keep; the differentiable volpath goes through the scan
form (path.trace with differentiable=True), as in the reference package.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device, to_device
from ..utils import profile
from .path import (RenderConfig, _make_bounce, _queue_entries, _trace_regen,
                   _fresh_state)

# scene keys whose arrays can carry gradients: materials, textures, lights,
# media, environment.  Geometry and acceleration tables are detached by
# design (make_interaction detaches its outputs).
_DIFF_PREFIXES = ("mat_", "tex_", "light_", "med_", "env_")


def split_scene(scene):
    """(diff, rest): the parameter arrays and the detached geometry and
    tables."""
    diff = {k: v for k, v in scene.items() if k.startswith(_DIFF_PREFIXES)}
    rest = {k: v for k, v in scene.items()
            if not k.startswith(_DIFF_PREFIXES)}
    return diff, rest


def _replay(scene, cam, meta, cfg, pixel_idx, sample_offset, q_total, rec,
            tput, prev_pdf, radiance):
    """Re-run one recorded iteration's shade math, differentiable in the
    scene parameters, tput, prev_pdf and radiance.  Returns the carry after
    the iteration's flush and refill (tput, prev_pdf, radiance) and the
    flushed radiance [k, 3]."""
    qi = rec["qi"].to(torch.int64)
    px, py, sidx, _, _, tme = _queue_entries(cam, cfg, pixel_idx,
                                             sample_offset, qi)
    k = qi.shape[0]
    replay = dict(hit_t=rec["hit_t"], hit_kind=rec["hit_kind"].to(torch.int64),
                  hit_idx=rec["hit_idx"].to(torch.int64),
                  hit_valid=rec["hit_valid"], occ=rec["occ"])
    bounce = _make_bounce(scene, meta, cfg, px, py,
                          tme if meta.has_motion else None, sidx, k,
                          replay=replay)
    st_in = _fresh_state(rec["o"], rec["d"], k, meta.camera_medium)
    st_in.update(tput=tput, radiance=radiance, prev_pdf=prev_pdf,
                 spec=rec["spec"], alive=rec["alive"],
                 rr_depth=rec["rr_depth"].to(torch.int64))
    b = rec["b"].to(torch.int64)
    st = bounce(st_in, b)
    alive = st["alive"] & (b + 1 < cfg.max_depth)
    finished = rec["alive"] & ~alive
    flush = torch.where(finished[:, None],
                        torch.where(rec["rad_ok"], st["radiance"], 0.0), 0.0)
    ranks = torch.cumsum(finished.to(torch.int64), 0) - 1
    take = finished & (rec["head"] + ranks < q_total)
    tk = take[:, None]
    return (torch.where(tk, 1.0, st["tput"]),
            torch.where(take, 1.0, st["prev_pdf"]),
            torch.where(tk, 0.0, st["radiance"]), flush)


class _RegenDiff(torch.autograd.Function):
    """Inputs: the run's settings (a dict) and the floating-point parameter
    arrays named in settings["names"]; output: the queue's radiance."""

    @staticmethod
    def forward(ctx, run, *params):
        scene = dict(run["rest"], **dict(zip(run["names"], params)))
        records = []
        syncs = profile.counters().get("host_syncs", 0)
        out, stats = _trace_regen(scene, run["cam"], run["meta"], run["cfg"],
                                  run["pixel_idx"], run["waves"],
                                  run["sample_offset"], run["lanes"],
                                  with_stats=True, records=records)
        if run["stats"] is not None:
            nbytes = sum(v.numel() * v.element_size()
                         for rec in records for v in rec.values())
            profile.count("host_syncs")
            run["stats"].update(iterations=stats["iterations"],
                                n_rays=int(stats["n_rays"]),
                                residual_bytes=nbytes,
                                lanes=records[0]["qi"].shape[0]
                                if records else 0,
                                host_syncs=profile.counters()["host_syncs"]
                                - syncs)
        ctx.run, ctx.records = run, records
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        # autograd may run this on its device thread: the spans carry it
        with profile.span("grad.backward"):
            run, records = ctx.run, ctx.records
            params = ctx.saved_tensors
            need = ctx.needs_input_grad[1:]
            grads = [torch.zeros_like(p) if nd else None
                     for p, nd in zip(params, need)]
            q_total = run["pixel_idx"].shape[0] * run["waves"]
            ct_tput = ct_pp = ct_rad = None
            for rec in reversed(records):
                k = rec["qi"].shape[0]
                if ct_tput is None:
                    ct_tput = rec["tput"].new_zeros((k, 3))
                    ct_pp = rec["tput"].new_zeros((k,))
                    ct_rad = rec["tput"].new_zeros((k, 3))
                ct_flush = g_out[torch.clamp(rec["qi"].to(torch.int64), 0,
                                             q_total - 1)]
                with profile.span("grad.replay"), torch.enable_grad():
                    leaves = [p.detach().requires_grad_(nd)
                              for p, nd in zip(params, need)]
                    scene = dict(run["rest"],
                                 **dict(zip(run["names"], leaves)))
                    tput = rec["tput"].detach().requires_grad_()
                    prev_pdf = rec["prev_pdf"].detach().requires_grad_()
                    radiance = torch.zeros_like(tput).requires_grad_()
                    outs = _replay(scene, run["cam"], run["meta"], run["cfg"],
                                   run["pixel_idx"], run["sample_offset"],
                                   q_total, rec, tput, prev_pdf, radiance)
                pairs = [(o, g) for o, g in zip(outs, (ct_tput, ct_pp, ct_rad,
                                                       ct_flush))
                         if o.requires_grad]
                wrt = [p for p, nd in zip(leaves, need) if nd]
                with profile.span("grad.autograd"):
                    gs = torch.autograd.grad([o for o, _ in pairs], wrt + [
                        tput, prev_pdf, radiance], [g for _, g in pairs],
                        allow_unused=True)
                it = iter(gs[:len(wrt)])
                for j, nd in enumerate(need):
                    if nd:
                        g = next(it)
                        if g is not None:
                            grads[j] += g
                ct_tput, ct_pp, ct_rad = (
                    torch.zeros_like(x) if g is None else g
                    for g, x in zip(gs[len(wrt):], (tput, prev_pdf, radiance)))
            return (None, *grads)


def _trace_regen_diff(scene, cam, meta, cfg: RenderConfig, pixel_idx,
                      waves: int, sample_offset, lanes=None, stats=None):
    if cfg.integrator == "volpath":
        raise NotImplementedError("trace_regen_diff does not support media "
                                  "(volpath): use the scan form")
    diff, rest = split_scene(scene)
    names = [k for k, v in diff.items() if v.is_floating_point()]
    rest.update({k: v for k, v in diff.items() if k not in names})
    run = dict(rest=rest, names=names, cam=cam, meta=meta, cfg=cfg,
               pixel_idx=pixel_idx, waves=int(waves),
               sample_offset=int(sample_offset), lanes=lanes, stats=stats)
    return _RegenDiff.apply(run, *(diff[k] for k in names))


def trace_regen_diff(scene, cam, meta, cfg: RenderConfig, pixel_idx,
                     waves: int, sample_offset, lanes: int | None = None,
                     device=None, stats: dict | None = None):
    """Differentiable trace_regen: the same queue, drain and refill, and the
    same return contract (radiance [waves * n_pixels, 3], wave-major), with
    gradients to the material, texture, light and medium arrays of `scene`
    (any of them that requires grad) through the recording forward and the
    replaying backward of the module docstring.  `stats`, a dict, receives
    the recording's "iterations", "n_rays", "lanes", "residual_bytes"
    (what the backward pass keeps) and "host_syncs" (its waits for the
    device).  The backward pass runs in the span "grad.backward",
    each iteration's shade replay in "grad.replay" and its
    torch.autograd.grad in "grad.autograd" (utils/profile.py).  Runs on
    the GPU unless device="cpu"."""
    dev = resolve_device(device)
    return _trace_regen_diff(to_device(scene, dev), to_device(cam, dev), meta,
                             cfg, pixel_idx.to(dev), waves, sample_offset,
                             lanes, stats)
