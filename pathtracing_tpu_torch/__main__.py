"""Command line (counterpart of pathtracing_tpu/__main__.py):

  python -m pathtracing_tpu_torch render --scene cornell --spp 64 --out img.ppm
  python -m pathtracing_tpu_torch render --model scene.glb --cache scene.npz \\
      --env-light 0.35 --sun 3 --regen --out img.ppm
  python -m pathtracing_tpu_torch render ... --device cpu
  python -m pathtracing_tpu_torch bench [--device cpu]

Renders run on the GPU unless --device cpu.  PNG / JPG output and the
images of glTF / OBJ materials need Pillow; PPM output does not.  `bench`
runs bench.py (its switches are in its docstring).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from pathlib import Path


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _build_scene(args, times):
    """(scene, cam, meta) from the cache, the model or the built-in scene;
    the seconds of each stage go into `times`."""
    from . import scenes as builtin
    from .io import load_gltf, load_obj, load_scene, save_scene
    from .io.cache import StaleCacheError
    from .scene.builder import SceneBuilder
    from .utils.profile import counters

    if args.cache and Path(args.cache).exists() and not args.rebuild:
        _log(f"[scene] loading cache {args.cache}")
        t0 = time.perf_counter()
        try:
            out = load_scene(args.cache, device=args.device)
            times["cache_load_s"] = time.perf_counter() - t0
            _log(f"[scene] cache load: {times['cache_load_s']:.2f}s "
                 f"accel={out[2].accel}")
            return out
        except StaleCacheError as e:
            _log(f"[scene] {e}; rebuilding")

    if args.model:
        b = SceneBuilder()
        p = Path(args.model)
        t0 = time.perf_counter()
        if p.suffix.lower() in (".gltf", ".glb"):
            stats = load_gltf(p, b, scale=args.scale)
        elif p.suffix.lower() == ".obj":
            stats = load_obj(p, b, scale=args.scale)
        else:
            raise SystemExit(f"unsupported model format: {p.suffix}")
        times["import_s"] = time.perf_counter() - t0
        _log(f"[scene] import {p.name}: {stats} ({times['import_s']:.2f}s)")
        if args.env_light:
            b.add_uniform_inf_light([args.env_light] * 3)
        if args.sun:
            b.add_distant_light(direction=(-0.3, -1.0, -0.3),
                                color=[args.sun] * 3)
        lf = [float(x) for x in args.look_from.split(",")]
        la = [float(x) for x in args.look_at.split(",")]
        b.set_camera(lf, la, math.radians(args.fov), tuple(args.resolution),
                     focus_angle=math.radians(args.focus_angle),
                     focus_distance=args.focus_distance)
        t0 = time.perf_counter()
        out = b.build(accel=args.accel, device=args.device)
        times["build_s"] = time.perf_counter() - t0
        _log(f"[scene] build (SAH BVH): {times['build_s']:.2f}s "
             f"accel={out[2].accel}")
    else:
        if args.scene not in builtin.SCENES:
            raise SystemExit(f"unknown scene {args.scene}; "
                             f"have {sorted(builtin.SCENES)}")
        t0 = time.perf_counter()
        out = builtin.SCENES[args.scene](resolution=tuple(args.resolution),
                                         device=args.device)
        times["build_s"] = time.perf_counter() - t0
    # the build's stages: build_tables_s (masks included), build_masks_s,
    # build_upload_s
    times.update({k.replace(".", "_"): v for k, v in counters().items()
                  if k.startswith("build.")})

    if args.cache:
        t0 = time.perf_counter()
        save_scene(args.cache, *out)
        times["cache_save_s"] = time.perf_counter() - t0
        _log(f"[scene] cached -> {args.cache} ({times['cache_save_s']:.2f}s)")
    return out


def _writer(out: Path):
    from .sensor import film as filmmod
    ext = out.suffix.lstrip(".").lower() or "png"
    writers = dict(png=filmmod.write_png, jpg=filmmod.write_jpg,
                   jpeg=filmmod.write_jpg, ppm=filmmod.write_ppm)
    if ext not in writers:
        raise SystemExit(f"unsupported image format: .{ext}")
    return ext, writers[ext]


def _turntable(args, scene, cam, meta, cfg):
    """Orbit the camera around look_at over N frames (written beside
    --out, in its format) and encode a video when ffmpeg is found."""
    import shutil
    import subprocess
    import numpy as np
    from .integrators.render import render
    from .scene.builder import SceneBuilder

    out = Path(args.out)
    ext, write = _writer(out)
    frames_dir = Path(str(out.with_suffix("")) + "_frames")
    frames_dir.mkdir(parents=True, exist_ok=True)
    look_at = np.asarray([float(x) for x in args.look_at.split(",")])
    look_from0 = np.asarray([float(x) for x in args.look_from.split(",")])
    rel = look_from0 - look_at
    radius = math.hypot(rel[0], rel[2])
    phi0 = math.atan2(rel[2], rel[0])
    for f in range(args.turntable):
        phi = phi0 + 2.0 * math.pi * f / args.turntable
        lf = look_at + np.asarray([radius * math.cos(phi), rel[1],
                                   radius * math.sin(phi)])
        b = SceneBuilder()   # the camera alone; the scene's tables stay
        b.set_camera(lf, look_at, math.radians(args.fov),
                     tuple(args.resolution),
                     focus_angle=math.radians(args.focus_angle),
                     focus_distance=args.focus_distance)
        cam_f = b._pack_camera(cam["origin"].device)
        film = render(scene, cam_f, meta, cfg, device=args.device)
        write(film, cam_f["resolution"], frames_dir / f"frame_{f:04d}.{ext}",
              tone_mapper=args.tonemap)
        print(f"\r[turntable] {f + 1}/{args.turntable}", end="",
              file=sys.stderr)
    _log("")
    if shutil.which("ffmpeg"):
        video = out if out.suffix == ".mp4" else out.with_suffix(".mp4")
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", "30", "-i",
             str(frames_dir / f"frame_%04d.{ext}"), "-pix_fmt", "yuv420p",
             str(video)], check=False, capture_output=True, timeout=3600)
        _log(f"[turntable] wrote {video}")
    else:
        _log(f"[turntable] frames in {frames_dir} (no ffmpeg found)")


def cmd_render(args):
    """Render as the flags say and write the image.  Returns dict(film,
    meta, times: the seconds of each stage, metrics: RenderTimer's,
    adaptive: render_adaptive's statistics or None).  With --profile DIR
    the scene build and the render run under utils/profile.py::trace_to:
    DIR/trace.json, a Chrome trace of torch.profiler's events and the
    program's spans (the build's build.* spans among them)."""
    if not args.profile:
        return _render_cmd(args)
    from .utils.profile import trace_to
    with trace_to(args.profile):
        return _render_cmd(args)


def _render_cmd(args):
    from .core.rng import SamplerConfig
    from .integrators.path import RenderConfig
    from .integrators.render import render
    from .parallel.distributed import initialize, is_coordinator
    from .utils.checkpoint import render_with_checkpoints
    from .utils.profile import RenderTimer
    import torch.distributed as dist

    if args.sharded and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        initialize()      # launched by torchrun: one rank per GPU
    times = {}
    scene, cam, meta = _build_scene(args, times)
    w, h = cam["resolution"]
    x = max(1, int(math.isqrt(args.spp)))
    cfg = RenderConfig(
        spp=args.spp, max_depth=args.max_depth, integrator=args.integrator,
        sampler=SamplerConfig(kind=args.sampler, x_samples=x,
                              y_samples=max(1, args.spp // x),
                              seed=args.seed),
        rays_per_batch=args.rays_per_batch,
        compact_after=args.compact_after,
        regenerate=args.regen)

    if args.turntable:
        _turntable(args, scene, cam, meta, cfg)
        return dict(film=None, meta=meta, times=times, metrics=None,
                    adaptive=None)

    def progress(done, total):
        print(f"\r[render] {100.0 * done / total:5.1f}%", end="",
              file=sys.stderr)

    stats = None
    t0 = time.perf_counter()
    with RenderTimer(w * h, args.spp, args.max_depth) as t:
        if args.sharded:
            from .parallel.mesh import render_sharded
            film = render_sharded(scene, cam, meta, cfg, device=args.device)
        elif args.adaptive:
            from .utils.adaptive import render_adaptive
            film, stats = render_adaptive(
                scene, cam, meta, cfg, base_spp=max(args.spp // 8, 4),
                target=args.adaptive, device=args.device)
            _log(f"\n[adaptive] mean spp {stats['mean_spp']:.1f}")
        elif args.checkpoint:
            film = render_with_checkpoints(scene, cam, meta, cfg, args.spp,
                                           args.checkpoint,
                                           every=args.checkpoint_every,
                                           device=args.device)
        else:
            film = render(scene, cam, meta, cfg, progress=progress,
                          device=args.device)
        t.result = film
    times["render_s"] = time.perf_counter() - t0
    _log("")

    if is_coordinator():
        out = Path(args.out)
        _, write = _writer(out)
        write(film, cam["resolution"], out, tone_mapper=args.tonemap)
        _log(f"[render] wrote {out}")
    return dict(film=film, meta=meta, times=times, metrics=t.metrics,
                adaptive=stats)


def cmd_bench(args):
    """The benchmark (bench.py); returns its JSON result."""
    from . import bench
    return bench.run(args)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pathtracing_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu)")
    r.add_argument("--scene", default="cornell")
    r.add_argument("--model", default=None,
                   help="path to .gltf/.glb/.obj (overrides --scene)")
    r.add_argument("--cache", default=None,
                   help="scene cache .npz: loaded when it exists, else "
                        "written after the build")
    r.add_argument("--rebuild", action="store_true")
    r.add_argument("--resolution", nargs=2, type=int, default=[512, 512])
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--max-depth", type=int, default=8)
    r.add_argument("--integrator", default="path",
                   choices=["simple", "path", "volpath"])
    r.add_argument("--sampler", default="stratified",
                   choices=["stratified", "uniform"])
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--accel", default="auto",
                   choices=["auto", "pallas", "beam", "bvh", "brute"],
                   help="auto picks by scene size (the traversal kernels "
                        "for triangle scenes of 4,096 prims or more)")
    r.add_argument("--rays-per-batch", type=int, default=1 << 16)
    r.add_argument("--compact-after", type=int, default=None,
                   help="tail compaction: gather surviving lanes into a "
                        "quarter-width batch after this many bounces")
    r.add_argument("--regen", action="store_true",
                   help="persistent wavefront: refill finished lanes with "
                        "fresh camera samples so multi-spp queues drain "
                        "with every lane busy")
    r.add_argument("--tonemap", default="reinhard_jodie")
    r.add_argument("--out", default="out.png")
    r.add_argument("--sharded", action="store_true",
                   help="shard over the ranks of the process group (launch "
                        "with torchrun, one rank per GPU)")
    r.add_argument("--adaptive", type=float, default=None,
                   help="adaptive sampling rel-variance target (ref: 1.5)")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=16)
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the scene build and the render with "
                        "torch.profiler and the program's spans into "
                        "DIR/trace.json (Chrome trace: chrome://tracing, "
                        "Perfetto)")
    # model-import camera and lights
    r.add_argument("--scale", type=float, default=1.0)
    r.add_argument("--look-from", default="0,1,-4")
    r.add_argument("--look-at", default="0,0.5,0")
    r.add_argument("--fov", type=float, default=40.0)
    r.add_argument("--focus-angle", type=float, default=0.0)
    r.add_argument("--focus-distance", type=float, default=0.0)
    r.add_argument("--env-light", type=float, default=None)
    r.add_argument("--sun", type=float, default=None)
    r.add_argument("--turntable", type=int, default=0,
                   help="render N orbit frames + encode video (ffmpeg)")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="run the benchmark (bench.py)")
    from .bench import add_arguments
    add_arguments(b)
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
