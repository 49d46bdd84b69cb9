"""The golden workload end to end (counterpart of tools/golden_run.py):
the faithful San-Miguel analog at 1920x1080, high spp, max_depth 64,
checkpointed, after a depth-128 one-spp probe frame.

    python -m pathtracing_tpu_torch.tools.golden_run [spp] [depth] [out_dir]
        [--device cuda|cpu]

spp defaults to 256, depth to 64, out_dir to golden_out.  It is the
analog of the reference tracer's published golden render (San Miguel,
1024 spp, 128 bounces, 5,027 s at 1080p on its CPU): a converged
high-spp render with a wall clock, the checkpoint machinery, long-run
drift and memory held over many frames.  The probe (GOLDEN_D128=0 skips
it) renders one regenerating 1-spp frame at depth 128, the reference's
deepest setting.  Then `run` renders spp samples through
utils/checkpoint.render_with_checkpoints, a checkpoint every 8 spp,
resuming from the checkpoint when one is there, and writes beside it
golden_progress_<spp>spp.json at every checkpoint, the image
(sanmiguel_analog_<h>p_<spp>spp_d<depth>.ppm, and .png when Pillow is
installed) and golden_run.json, whose line it also prints.  The wall
clock counts the samples rendered by this invocation only.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import torch

from ..core.device import resolve_device
from ..integrators.path import RenderConfig
from ..integrators.render import render
from ..sensor import film as filmmod
from ..utils.checkpoint import load_checkpoint, render_with_checkpoints

REFERENCE_WALL_S = 5027
REFERENCE_CONFIG = "the reference tracer's San Miguel 1024 spp d128"
METRIC = "golden_sanmiguel_analog_1080p"
LANES = 1 << 16


def _now(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def probe_d128(scene, cam, meta):
    """One regenerating 1-spp frame at depth 128: dict(seconds, mean);
    raises unless the image mean is finite."""
    dev = cam["origin"].device
    cfg = RenderConfig(spp=1, max_depth=128, integrator="path",
                       rays_per_batch=LANES, regenerate=True)
    t0 = _now(dev)
    film = render(scene, cam, meta, cfg, spp=1, device=dev)
    mean = float(filmmod.finalize(film).mean())
    seconds = _now(dev) - t0
    if not math.isfinite(mean):
        raise RuntimeError(f"depth-128 probe: image mean {mean}")
    print(f"[golden] depth-128 1spp frame ok in {seconds:.1f}s (mean "
          f"{mean:.5f})", flush=True)
    return dict(seconds=seconds, mean=mean)


def _rates(marks, npix, done, done0, total, seconds):
    """(samples/s of this invocation, steady samples/s between the first
    and the last checkpoint or None, the full render's wall at the second
    if there is one, else the first)."""
    rate = npix * (done - done0) / max(seconds, 1e-9)
    steady = None
    if len(marks) >= 2:
        (d1, e1), (dn, en) = marks[0], marks[-1]
        steady = npix * (dn - d1) / max(en - e1, 1e-9)
    return rate, steady, npix * total / max(steady or rate, 1e-9)


def run(scene, cam, meta, spp, depth, out_dir, every=8, progress=None):
    """Render spp samples at `depth` with a checkpoint every `every` spp
    in out_dir (resumed when present), writing the progress JSON at each
    checkpoint, then the image and golden_run.json.  progress(done,
    total), when given, is called after each checkpoint's record.
    Returns the summary dict (the printed JSON line) with "film"."""
    dev = cam["origin"].device
    w, h = cam["resolution"]
    npix = w * h
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = RenderConfig(spp=spp, max_depth=depth, integrator="path",
                       rays_per_batch=LANES, regenerate=True)
    ckpt = out_dir / f"golden_ckpt_{spp}spp_d{depth}.npz"
    done0 = 0
    if ckpt.exists():
        done0 = load_checkpoint(ckpt, device=dev)[1]
        print(f"[golden] resuming from checkpoint at {done0} spp",
              flush=True)
    marks = []                       # (spp done, seconds) per checkpoint
    t0 = _now(dev)

    def record(done, total):
        el = _now(dev) - t0
        marks.append((done, el))
        rate, steady, full = _rates(marks, npix, done, done0, total, el)
        print(f"[golden] {done}/{total} spp, {el:.1f}s elapsed, "
              f"{rate:,.0f} samples/s"
              + (f" (steady {steady:,.0f})" if steady else ""), flush=True)
        prog = dict(metric=METRIC, status="in_progress", spp_done=done,
                    spp_target=total, depth=depth, resumed_from_spp=done0,
                    wall_s_this_invocation=round(el, 3),
                    samples_per_s=round(rate, 1),
                    steady_samples_per_s=round(steady, 1) if steady
                    else None,
                    full_wall_s_at_rate=round(full, 1),
                    reference_wall_s=REFERENCE_WALL_S,
                    reference_config=REFERENCE_CONFIG)
        (out_dir / f"golden_progress_{total}spp.json").write_text(
            json.dumps(prog, indent=1))
        if progress:
            progress(done, total)

    film = render_with_checkpoints(scene, cam, meta, cfg, spp, ckpt,
                                   every=every, progress=record, device=dev)
    wall = _now(dev) - t0
    img = out_dir / f"sanmiguel_analog_{h}p_{spp}spp_d{depth}.ppm"
    filmmod.write_ppm(film, (w, h), img)
    images = [str(img)]
    try:
        filmmod.write_png(film, (w, h), img.with_suffix(".png"))
        images.append(str(img.with_suffix(".png")))
    except ImportError:
        pass                         # no Pillow: the PPM only
    mean = float(filmmod.finalize(film).mean())
    rate, steady, full = _rates(marks, npix, spp, done0, spp, wall)
    summary = dict(metric=METRIC, status="complete", spp=spp, depth=depth,
                   resolution=[w, h], resumed_from_spp=done0,
                   wall_s_this_invocation=round(wall, 3),
                   samples_per_s=round(rate, 1),
                   steady_samples_per_s=round(steady, 1) if steady
                   else None,
                   full_wall_s_at_rate=round(full, 1), image_mean=mean,
                   images=images, reference_wall_s=REFERENCE_WALL_S,
                   reference_config=REFERENCE_CONFIG)
    print(json.dumps(summary), flush=True)
    (out_dir / "golden_run.json").write_text(json.dumps(summary, indent=1))
    if not mean > 0.0:
        raise RuntimeError(f"golden image mean {mean}")
    return dict(summary, film=film)


def main(argv=None):
    from ..scenes import sanmiguel_analog
    ap = argparse.ArgumentParser(prog="pathtracing_tpu_torch.tools."
                                      "golden_run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("spp", type=int, nargs="?", default=256)
    ap.add_argument("depth", type=int, nargs="?", default=64)
    ap.add_argument("out_dir", nargs="?", default="golden_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = _now(dev)
    scene, cam, meta = sanmiguel_analog(resolution=(1920, 1080), device=dev)
    print(f"[golden] scene {meta.n_tri:,} tris accel={meta.accel} build "
          f"{_now(dev) - t0:.1f}s", flush=True)
    if os.environ.get("GOLDEN_D128", "1") != "0":
        probe_d128(scene, cam, meta)
    return run(scene, cam, meta, args.spp, args.depth, args.out_dir)


if __name__ == "__main__":
    main()
