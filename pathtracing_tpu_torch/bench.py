"""Benchmark of pathtracing_tpu_torch (counterpart of the root bench.py):
the San-Miguel-class workload forward and forward + backward.

    python -m pathtracing_tpu_torch.bench [--device cuda|cpu]
    python -m pathtracing_tpu_torch bench [--device cuda|cpu]

Prints ONE last JSON line {"metric", "value", "unit", "vs_baseline",
"secondary"} with the root bench.py's key names where the meaning is the
same.  The primary metric renders scenes.sanmiguel_analog (10.5M
triangles, 2,500 alpha-foliage shrubs flattened to world triangles) at
1920x1080, path integrator, max_depth 64, 1 spp; `vs_baseline` divides by
the reference CPU tracer's San Miguel figure (1920x1080 x 100 spp in
349 s).  Secondary numbers: rays per camera sample and the trace rate on
the same scene, fwd+bwd rates (tools/bench_grad.py), the bounce kernel's
dispatch time with its per-ray counters and bound (tools/roofline.py),
the legacy untextured scene at depth 32 and the Cornell box.

Switches (environment, the root bench.py's): BENCH_FAST (512x512, 200K
triangles, depth 8, 64 shrubs), N_TRIS, BENCH_DEPTH, BENCH_FOLIAGE,
BENCH_REPS (timed repetitions, min taken), BENCH_REGEN / BENCH_COMPACT
(scheduling_form), BENCH_BWD_FORM (regen | scan), BENCH_BWD_COMPACT,
BENCH_BWD_D64, BENCH_LEGACY.  --res and --cornell-res / --cornell-spp
shrink the frames (tests run the whole bench on the CPU that way).

Timing: a warm frame, then the least of BENCH_REPS timed frames, each
between device synchronizations.  Eager PyTorch compiles nothing; the
warm frame builds the CUDA kernels and fills the caching allocator.  A
fault anywhere ends the run with a non-zero exit: nothing is retried.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from .core.device import resolve_device
from .integrators.path import RenderConfig, _trace, _trace_regen
from .integrators.render import regen_schedule, render

BASELINE_SAMPLES_PER_S = 1920 * 1080 * 100 / 349.0  # reference main.cpp:332
LANES = 1 << 16


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _now(dev):
    """The host clock after the device has caught up."""
    _sync(dev)
    return time.perf_counter()


def _reps(default="3"):
    return max(1, int(os.environ.get("BENCH_REPS", default)))


def scheduling_form():
    """(compact_after, regenerate) for the forward metric: ray
    regeneration unless BENCH_REGEN=0; BENCH_COMPACT=n selects tail
    compaction instead, which is exclusive with regeneration."""
    compact = int(os.environ.get("BENCH_COMPACT", "0")) or None
    regen_env = os.environ.get("BENCH_REGEN")
    regen = bool(int(regen_env)) if regen_env is not None else True
    if compact and regen:
        if regen_env is not None:
            print("[bench] NOTE: BENCH_COMPACT overrides the explicit "
                  "BENCH_REGEN=1 request — running COMPACTION, not "
                  "regeneration", flush=True)
        regen = False
    return compact, regen


def _timed_frames(scene, cam, meta, cfg, spp, reps, warm, stats):
    """A warm frame (if asked), then `reps` timed frames at sample_offset
    spp * (r + 1).  Returns (seconds of each timed frame, warm seconds or
    None, the last film)."""
    dev = cam["origin"].device
    warm_s = None
    if warm:
        t0 = _now(dev)
        render(scene, cam, meta, cfg, spp=spp, device=dev)
        warm_s = _now(dev) - t0
    times = []
    for r in range(reps):
        t0 = _now(dev)
        film = render(scene, cam, meta, cfg, spp=spp,
                      sample_offset=spp * (r + 1), device=dev, stats=stats)
        times.append(_now(dev) - t0)
    return times, warm_s, film


def bench_mesh_forward(scene, cam, meta, res, spp, depth, compact, regen,
                       reps=None, warm=True, stats=None):
    """Full-frame forward render; returns (camera samples/s, film of the
    last timed frame).  reps: timed frames (default BENCH_REPS, 3), the
    least time taken; stats: render()'s statistics, accumulated over the
    timed frames."""
    cfg = RenderConfig(spp=spp, max_depth=depth, integrator="path",
                       rays_per_batch=LANES, compact_after=compact,
                       regenerate=regen)
    return bench_frame(scene, cam, meta, cfg, reps, warm, stats)


def bench_frame(scene, cam, meta, cfg, reps=None, warm=True, stats=None):
    """bench_mesh_forward's timing of a frame rendered under `cfg` (any
    integrator, cfg.spp samples at the camera's resolution)."""
    w, h = cam["resolution"]
    times, warm_s, film = _timed_frames(scene, cam, meta, cfg, cfg.spp,
                                        reps or _reps(), warm, stats)
    timed = min(times)
    warm_txt = "none" if warm_s is None else f"{warm_s:.1f}s"
    print(f"[bench] fwd d{cfg.max_depth}: warm {warm_txt}, timed min"
          f"{[round(t, 2) for t in times]} = {timed:.2f}s / "
          f"{w * h * cfg.spp} samples", flush=True)
    return w * h * cfg.spp / timed, film


def bench_mesh_rays(scene, cam, meta, depth, regen, warm=True):
    """(rays per camera sample, traced rays/s) under the forward metric's
    scheduling form (a regenerating drain, or plain waves) over the
    queue's row tiles spread evenly over the frame height, so the
    population samples the whole frame.  The timed run is sample_offset 1
    after a warm run at 0.  A frame of fewer than LANES pixels is one
    tile of its own rows (the reference's tile would start above the
    frame's top row)."""
    cfg = RenderConfig(spp=1, max_depth=depth, integrator="path",
                       rays_per_batch=LANES, regenerate=regen)
    dev = cam["origin"].device
    w, h = cam["resolution"]
    rows_per = max(1, min(LANES // w, h))
    n_tiles = -(-h // rows_per)
    g_tiles, _ = regen_schedule(n_tiles, 1)
    picks = sorted({int(round(i * (n_tiles - 1) / max(1, g_tiles - 1)))
                    for i in range(g_tiles)})
    row_starts = [min(t * rows_per, h - rows_per) for t in picks]
    pixel_idx = torch.cat([torch.arange(r0 * w, (r0 + rows_per) * w,
                                        dtype=torch.int64, device=dev)
                           for r0 in row_starts])
    q_total = pixel_idx.shape[0]

    def run(sample_offset):
        if regen:
            _, st = _trace_regen(scene, cam, meta, cfg, pixel_idx, 1,
                                 sample_offset, lanes=LANES,
                                 with_stats=True)
            return float(st["n_rays"])
        from .sensor.camera import camera_lanes
        n_rays = 0.0
        for b0 in range(0, q_total, LANES):
            pix = pixel_idx[b0:b0 + LANES]
            px, py = pix % w, pix // w
            sidx = torch.full_like(pix, sample_offset)
            o, d, tm, _ = camera_lanes(cam, cfg.sampler, px, py, sidx)
            _, st = _trace(scene, meta, cfg, o, d, tm, px, py, sidx,
                           with_stats=True)
            n_rays += float(st["n_rays"])
        return n_rays

    if warm:
        run(0)
    t0 = _now(dev)
    n2 = run(1)
    dt = _now(dev) - t0
    rays_per_sample = n2 / q_total
    print(f"[bench] rays: {rays_per_sample:.3f} rays/sample, "
          f"{n2 / dt:,.0f} rays/s over {q_total} samples in {dt:.2f}s",
          flush=True)
    return rays_per_sample, n2 / dt


def bench_mesh_fwd_bwd_frame(scene, cam, meta, depth=8, compact=None,
                             warm=True):
    """fwd+bwd at frame scale in the per-row-tile scan form (gradient of
    the full-frame radiance sum in the material base colors,
    tools/bench_grad.fwd_bwd_frame with compact_after=compact): a warm
    run, then one timed.  Returns bench_grad's dict of the timed run
    (samples_per_s, launches, ...); raises on a non-finite gradient."""
    from .tools.bench_grad import fwd_bwd_frame
    w, h = cam["resolution"]
    warm_s = fwd_bwd_frame(scene, cam, meta, depth, compact)["seconds"] \
        if warm else None
    r = fwd_bwd_frame(scene, cam, meta, depth, compact)
    if not r["finite"]:
        raise RuntimeError("non-finite gradient")
    warm_txt = "none" if warm_s is None else f"{warm_s:.1f}s"
    print(f"[bench] fwd+bwd frame d{depth}: warm {warm_txt}, timed "
          f"{r['seconds']:.2f}s / {w * h} samples", flush=True)
    return r


def bench_mesh_fwd_bwd_regen(scene, cam, meta, depth, reps=None, warm=True):
    """fwd+bwd at frame scale through the recording wavefront
    (tools/bench_grad.fwd_bwd_regen: trace_regen_diff over the forward
    metric's queue groups), the same loss as bench_mesh_fwd_bwd_frame: a
    warm run, then the fastest of `reps` (default BENCH_REPS, else 3 up to
    depth 16 and 1 deeper).  Returns bench_grad's dict of that run; raises
    on a non-finite gradient."""
    from .tools.bench_grad import fwd_bwd_regen
    w, h = cam["resolution"]
    warm_s = fwd_bwd_regen(scene, cam, meta, depth)["seconds"] \
        if warm else None
    runs = []
    for _ in range(reps or _reps("3" if depth <= 16 else "1")):
        r = fwd_bwd_regen(scene, cam, meta, depth)
        if not r["finite"]:
            raise RuntimeError("non-finite gradient (regen_diff)")
        runs.append(r)
    best = min(runs, key=lambda r: r["seconds"])
    warm_txt = "none" if warm_s is None else f"{warm_s:.1f}s"
    print(f"[bench] fwd+bwd regen d{depth}: warm {warm_txt}, timed min"
          f"{[round(r['seconds'], 2) for r in runs]} = "
          f"{best['seconds']:.2f}s / {w * h} samples", flush=True)
    return best


def bench_bounce_kernel(scene, meta, n=LANES, timing_calls=20):
    """The bounce-class closest-hit dispatch on the scene's own two-level
    opaque tables (K1, accel/trace2.py) at the main path's pops: ms per
    n-ray dispatch (CUDA events around `timing_calls` back-to-back calls
    after a warm one), the kernel's per-ray counters (L1 visits, leaf
    blocks tested, top-level slab tests) and the dispatch's bound
    (tools/roofline.py).  Rays: random off-surface origins with
    downward-hemisphere directions, sorted by first entered block as the
    dispatch sorts bounce rays.  {} without two-level tables, on a moving
    scene or off the card (the counters are the kernel's)."""
    from .accel import trace2
    from .scene.intersect import _first_block_key, _subset_scene
    from .tools.roofline import traversal_bound
    sub = _subset_scene(scene, "pk_")
    if ("pk_l1_base" not in sub or meta.has_motion
            or sub["pk_tri"].device.type != "cuda"):
        return {}
    dev = sub["pk_tri"].device
    rng = np.random.default_rng(2)
    lo = scene["scene_lo"].cpu().numpy()
    hi = scene["scene_hi"].cpu().numpy()
    o = np.stack([rng.uniform(lo[0], hi[0], n),
                  rng.uniform(lo[1] * 0.9 + hi[1] * 0.1,
                              lo[1] * 0.7 + hi[1] * 0.3, n),
                  rng.uniform(lo[2], hi[2], n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o).to(dev)
    d = torch.from_numpy(d).to(dev)
    perm = torch.argsort(_first_block_key(sub, o, d), stable=True)
    o, d = o[perm].contiguous(), d[perm].contiguous()
    t_max = torch.full((n,), 1e30, device=dev)
    pops = meta.block_pops

    def call():
        return trace2.tri_intersect2(sub, o, d, t_max, pops=pops)

    call()
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(timing_calls):
        call()
    b.record()
    torch.cuda.synchronize(dev)
    ms = a.elapsed_time(b) / timing_calls
    res = trace2.tri_intersect2(sub, o, d, t_max, pops=pops, counters=True)
    bound = traversal_bound(sub, res, n)
    per = bound["per_ray"]
    print(f"[bench] bounce kernel: {ms:.3f} ms per {n}-ray dispatch (pops "
          f"{pops}); per ray: {bound['what']}; bound {bound['bound_ms']:.4f}"
          f" ms ({bound['bound_by']})", flush=True)
    return {"bounce_ms_64k": round(ms, 4),
            "l1_visits_per_ray": round(per["l1_visits"], 3),
            "leaf_blocks_per_ray": round(per["leaf_blocks"], 3),
            "top_slab_tests_per_ray": round(per["top_slab_tests"], 2),
            "bounce_bound_ms_64k": round(bound["bound_ms"], 4),
            "bounce_bound_by": bound["bound_by"]}


def bench_cornell(res=(512, 512), spp=32, reps=None, warm=True,
                  device=None):
    """The Cornell box, path integrator, depth 8, `spp` samples: a warm
    frame, then the least of `reps` timed frames.  Returns camera
    samples/s."""
    from .scenes import cornell_box
    cfg = RenderConfig(spp=spp, max_depth=8, integrator="path",
                       rays_per_batch=LANES)
    scene, cam, meta = cornell_box(resolution=tuple(res), device=device)
    times, _, _ = _timed_frames(scene, cam, meta, cfg, spp, reps or _reps(),
                                warm, None)
    print(f"[bench] cornell {res[0]}x{res[1]} {spp} spp: timed min"
          f"{[round(t, 2) for t in times]} s", flush=True)
    return res[0] * res[1] * spp / min(times)


def result(depth, res, fwd_rate, rays_per_sample, rays_rate, fb_rate,
           fb_deep_rate, kernel_stats, legacy_rate, cornell_rate):
    """The bench's JSON result from its measurements: the primary forward
    rate at `depth`, rays per camera sample and the trace rate, the
    fwd+bwd rates at depth 8 and at `depth` (that key only when it is not
    8), the bounce kernel's row (bench_bounce_kernel), the legacy and the
    Cornell rates."""
    return {
        "metric": f"camera_samples_per_sec_mesh10M_1080p_path_d{depth}",
        "value": round(fwd_rate, 1),
        "unit": "samples/s",
        "vs_baseline": round(fwd_rate / BASELINE_SAMPLES_PER_S, 4),
        "secondary": {
            # fwd_rate x rays/sample, both under the same scheduling form:
            # a derived product (trace_rays_per_sec_frame_sampled is the
            # direct timing)
            "derived_rays_per_sec_mesh10M":
                round(fwd_rate * rays_per_sample, 1),
            "rays_per_camera_sample": round(rays_per_sample, 3),
            "trace_rays_per_sec_frame_sampled": round(rays_rate, 1),
            f"fwd_bwd_samples_per_sec_mesh10M_{res[1]}p_d8":
                round(fb_rate, 1),
            **({f"fwd_bwd_samples_per_sec_mesh10M_{res[1]}p_d{depth}":
                round(fb_deep_rate, 1)} if depth != 8 else {}),
            **kernel_stats,
            "camera_samples_per_sec_legacy_gentle_1080p_d32":
                round(legacy_rate, 1),
            "vs_baseline_legacy_gentle":
                round(legacy_rate / BASELINE_SAMPLES_PER_S, 4),
            "camera_samples_per_sec_cornell_512_path_d8":
                round(cornell_rate, 1),
            "vs_baseline_cornell":
                round(cornell_rate / BASELINE_SAMPLES_PER_S, 3),
        },
    }


def add_arguments(ap):
    """The bench's options, on its own parser and on the CLI's `bench`."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    ap.add_argument("--res", nargs=2, type=int, default=None,
                    help="resolution of the mesh frames (default 1920 "
                         "1080, 512 512 under BENCH_FAST)")
    ap.add_argument("--cornell-res", type=int, default=512)
    ap.add_argument("--cornell-spp", type=int, default=32)


def main(argv=None):
    """Parse argv, run the bench; print and return its JSON result."""
    ap = argparse.ArgumentParser(prog="pathtracing_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    add_arguments(ap)
    return run(ap.parse_args(argv))


def run(args):
    """The bench with parsed options (add_arguments)."""
    from .scenes import sanmiguel_analog
    dev = resolve_device(args.device)
    fast = bool(os.environ.get("BENCH_FAST"))
    res = tuple(args.res) if args.res else (
        (512, 512) if fast else (1920, 1080))
    n_tris = int(os.environ.get("N_TRIS", 200_000 if fast else 10_500_000))
    # depth 64 = the reference's maxDepth for every logged San Miguel
    # timing (main.cpp:318-332)
    depth = int(os.environ.get("BENCH_DEPTH", "8" if fast else "64"))
    foliage = int(os.environ.get("BENCH_FOLIAGE", 64 if fast else 2500))
    spp = 1

    t0 = _now(dev)
    scene, cam, meta = sanmiguel_analog(resolution=res, n_tris=n_tris,
                                        foliage=foliage, device=dev)
    print(f"[bench] scene: {meta.n_tri:,} tris + {meta.n_inst} alpha-"
          f"foliage instances ({meta.n_obj_tri} obj tris), accel="
          f"{meta.accel}, build {_now(dev) - t0:.1f}s on {dev}", flush=True)

    compact, regen = scheduling_form()
    fwd_rate, _ = bench_mesh_forward(scene, cam, meta, res, spp, depth,
                                     compact, regen)
    rays_per_sample, rays_rate = bench_mesh_rays(scene, cam, meta, depth,
                                                 regen)
    bwd_compact = os.environ.get("BENCH_BWD_COMPACT", "3")
    # fwd+bwd form: the recording wavefront by default; BENCH_BWD_FORM=scan
    # selects the per-tile scan form with tail compaction
    if os.environ.get("BENCH_BWD_FORM", "regen") == "regen":
        fb = bench_mesh_fwd_bwd_regen(scene, cam, meta, depth=8)
    else:
        fb = bench_mesh_fwd_bwd_frame(
            scene, cam, meta, depth=8,
            compact=None if bwd_compact in ("off", "0")
            else int(bwd_compact))
    fb64_rate = 0.0
    if not fast and os.environ.get("BENCH_BWD_D64", "1") != "0":
        fb64_rate = bench_mesh_fwd_bwd_regen(scene, cam, meta,
                                             depth=depth)["samples_per_s"]
    kernel_stats = bench_bounce_kernel(scene, meta)

    # the legacy untextured terrain at depth 32 (BENCH_LEGACY=0 skips it)
    legacy_rate = 0.0
    if not fast and os.environ.get("BENCH_LEGACY", "1") != "0":
        del scene                   # free the faithful tables first
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = _now(dev)
        scene_l, cam_l, meta_l = sanmiguel_analog(
            resolution=res, n_tris=n_tris, faithful=False, device=dev)
        print(f"[bench] legacy scene: {meta_l.n_tri:,} tris, build "
              f"{_now(dev) - t0:.1f}s", flush=True)
        legacy_rate, _ = bench_mesh_forward(scene_l, cam_l, meta_l, res,
                                            spp, 32, compact, regen)
        del scene_l

    cornell_rate = bench_cornell((args.cornell_res,) * 2, args.cornell_spp,
                                 device=dev)

    out = result(depth, res, fwd_rate, rays_per_sample, rays_rate,
                 fb["samples_per_s"], fb64_rate, kernel_stats, legacy_rate,
                 cornell_rate)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
