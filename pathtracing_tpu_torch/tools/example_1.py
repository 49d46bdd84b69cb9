"""Fully commented API walkthrough (counterpart of examples/example_1.py,
itself the analog of the reference's examples/example_1.cpp, its 13-step
scene/render tutorial).

    python -m pathtracing_tpu_torch.tools.example_1                  # GPU
    python -m pathtracing_tpu_torch.tools.example_1 --device cpu \\
        --res 160 120 --spp 4 --out example_1.ppm

A `.png` needs Pillow; `.ppm` needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch

from ..core.device import resolve_device
from ..core.rng import SamplerConfig
from ..integrators.path import RenderConfig
from ..integrators.render import render
from ..scene.builder import SceneBuilder
from ..sensor import film as filmmod

# The example's sampler grid: 8 x 8 strata for its 64 spp.
GRID = 8


def build_scene(resolution=(640, 480), device=None):
    """Steps 1-9: the walkthrough's scene, built on `device` (the GPU
    unless device="cpu").  Returns (scene, cam, meta)."""
    # 1. A scene starts from a SceneBuilder (the reference builds a Scene
    #    object and Adds primitives; here everything is staged host-side
    #    and packed into flat device tensors by build()).
    b = SceneBuilder()

    # 2. Textures live in a pool; ids are plain ints.  This checker uses two
    #    solid sub-textures (CheckerTexture analog).
    white = b.textures.add_solid((0.9, 0.9, 0.9))
    black = b.textures.add_solid((0.2, 0.2, 0.2))
    checker = b.textures.add_checker(white, black, uv_scale=(0.1, 0.1))

    # 3. Materials: glTF-style metallic-roughness diffuse, rough glass, thin
    #    glass, and a mirror (the reference's four material classes).
    floor_mat = b.add_diffuse((1.0, 1.0, 1.0), roughness=1.0, base_tex=checker)
    red_mat = b.add_diffuse((0.8, 0.15, 0.1), roughness=0.35, metallic=0.1)
    glass = b.add_dielectric(ior=1.5, roughness=0.0)
    mirror = b.add_conductor((0.9, 0.9, 0.95))

    # 4. Shapes: quads take (corner, edge_u, edge_v); spheres (center,
    #    radius).
    b.add_quad([-8, 0, -8], [16, 0, 0], [0, 0, 16], material=floor_mat)
    b.add_sphere([-2.2, 1.0, 0.0], 1.0, material=red_mat)
    b.add_sphere([0.0, 1.0, 0.0], 1.0, material=glass)
    b.add_sphere([2.2, 1.0, 0.0], 1.0, material=mirror)

    # 5. An area light is any emissive shape (per-shape AreaLight analog).
    b.add_quad([-1.5, 5.0, -1.5], [3, 0, 0], [0, 0, 3], emission=(14, 14, 14))

    # 6. A participating medium (HomogeneusMedium): attach to a shape to
    #    fill its interior; set_scene_medium() would fill the whole world.
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.4, 0.4, 0.4),
                       g=0.3)
    b.add_sphere([0.0, 1.0, 2.6], 0.8, material=glass, medium=fog)

    # 7. Infinite light: uniform sky here; add_env_light_from_file("sky.hdr")
    #    or add_function_inf_light(fn) also work.
    b.add_uniform_inf_light((0.25, 0.35, 0.5))

    # 8. The acceleration structure is chosen at build() (accel="auto" picks
    #    brute / pallas (the CUDA traversal kernels' tables) / beam by scene
    #    size) — the Scene::BuildTlas step.  These seven analytic prims take
    #    the brute scan: no kernel.

    # 9. Camera: thin lens; fov is the full vertical angle in radians; the
    #    focus controls add defocus blur (set both to 0 for a pinhole).
    b.set_camera(look_from=[0, 3.0, -8.0], look_at=[0, 1.0, 0],
                 fov=math.radians(45.0), resolution=tuple(resolution),
                 focus_angle=math.radians(1.2), focus_distance=8.0)

    return b.build(device=device)


def render_config(spp=64, depth=8):
    """Step 10's RenderConfig: integrator ("simple" | "path" | "volpath"),
    sample counts, bounce depth, stratified sampler grid, film filter.  The
    grid stays 8 x 8 up to 64 spp and grows to the least square of at least
    `spp` strata above: the stratified sampler's permutation
    (core/rng.permutation_element, as the reference's) can loop for ever on
    a sample index past its strata count."""
    side = max(GRID, math.isqrt(spp - 1) + 1)
    return RenderConfig(spp=spp, max_depth=depth, integrator="volpath",
                        sampler=SamplerConfig(x_samples=side, y_samples=side,
                                              seed=0))


def _writer(out):
    """Step 12's writer, by the extension: .png (Pillow) or .ppm."""
    ext = Path(out).suffix.lower()
    if ext == ".ppm":
        return filmmod.write_ppm
    if ext != ".png":
        raise ValueError(f"--out {out}: the walkthrough writes .png or .ppm")
    try:
        import PIL  # noqa: F401
    except ImportError:
        raise RuntimeError(f"--out {out} needs Pillow, which is not "
                           f"installed; write a PPM instead (--out x.ppm)") \
            from None
    return filmmod.write_png


def main(argv=None):
    """Render the walkthrough's scene and write it.  Returns dict(film,
    resolution, seconds (the render, device-synced), samples_per_s,
    out)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    ap.add_argument("--res", type=int, nargs=2, default=(640, 480),
                    metavar=("W", "H"))
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--out", default="example_1.png",
                    help=".png (needs Pillow) or .ppm")
    args = ap.parse_args(argv)
    write = _writer(args.out)           # before the render: fail early
    dev = resolve_device(args.device)
    res = tuple(args.res)
    scene, cam, meta = build_scene(res, dev)

    # 10. Render config (see render_config).
    cfg = render_config(args.spp, args.depth)

    # 11. Render: returns the film accumulator (RGB + weight); render() can
    #     be resumed via sample_offset, checkpointed (utils.checkpoint), run
    #     adaptively (utils.adaptive), or sharded over GPUs through
    #     torch.distributed (parallel.render_sharded).
    t0 = time.perf_counter()
    film = render(scene, cam, meta, cfg, device=dev,
                  progress=lambda d, t: print(f"\r{100 * d / t:5.1f}%",
                                              end="", flush=True))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    print()
    samples = res[0] * res[1] * args.spp
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{res[0]}x{res[1]} x {args.spp} spp, volpath depth {args.depth}: "
          f"{seconds:.2f} s, {samples / seconds:.1f} samples/s on {where}",
          flush=True)

    # 12. Write the image: tone mapping (reinhard_jodie | aces | reinhard)
    #     and linear->sRGB happen in the writer, like Film::WritePNG.
    write(film, cam["resolution"], args.out)

    # 13. Gradients: render with RenderConfig(differentiable=True), take a
    #     loss of the film and call .backward() to optimise scene parameters
    #     (the material, texture, light and medium tensors) — see
    #     tools/inverse_rendering.py and parallel.train_step_sharded.
    print(f"wrote {args.out}")
    return dict(film=film, resolution=res, seconds=seconds,
                samples_per_s=samples / seconds, out=args.out)


if __name__ == "__main__":
    main()
