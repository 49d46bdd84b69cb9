"""Inverse rendering: recover material albedos from a target image
(counterpart of examples/inverse_rendering.py).

Renders a target with known albedos, perturbs them, and runs gradient
descent on the mean squared error between differentiable re-renders (the
scan form: RenderConfig(differentiable=True), detached sampling, the same
sample streams every step) and the target.

    python -m pathtracing_tpu_torch.tools.inverse_rendering            # GPU
    python -m pathtracing_tpu_torch.tools.inverse_rendering --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from ..core.device import resolve_device
from ..core.rng import SamplerConfig
from ..integrators.path import RenderConfig
from ..integrators.render import render_tile
from ..scene.builder import SceneBuilder
from ..sensor import film as filmmod

# the example's starting error on (red, blue, floor) and its step size
GUESS_OFFSET = ((-0.4, 0.3, 0.3), (0.5, 0.2, -0.4), (0.2, -0.2, 0.2))
LR = 3.0


def build_scene(res, device):
    b = SceneBuilder()
    red = b.add_diffuse((0.8, 0.15, 0.1), roughness=0.9)
    blue = b.add_diffuse((0.1, 0.2, 0.75), roughness=0.9)
    floor = b.add_diffuse((0.5, 0.5, 0.5), roughness=1.0)
    b.add_quad([-6, 0, -6], [12, 0, 0], [0, 0, 12], material=floor)
    b.add_sphere([-1.3, 1.0, 0], 1.0, material=red)
    b.add_sphere([1.3, 1.0, 0], 1.0, material=blue)
    b.add_quad([-2, 5, -2], [4, 0, 0], [0, 0, 4], emission=(10, 10, 10))
    b.add_uniform_inf_light((0.3, 0.35, 0.45))
    b.set_camera([0, 2.5, -6], [0, 1, 0], math.radians(40), res)
    return b.build(device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    ap.add_argument("--res", type=int, default=48, help="square image side")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = (args.res, args.res)
    scene, cam, meta = build_scene(res, dev)
    cfg = RenderConfig(spp=args.spp, max_depth=args.depth,
                       differentiable=True, rr_start=10,
                       sampler=SamplerConfig(x_samples=4, y_samples=2,
                                             seed=7))
    pix = torch.arange(res[0] * res[1], device=dev)

    def render_with(mat_base):
        film = filmmod.new_film(res, device=dev)
        film = render_tile(dict(scene, mat_base=mat_base), cam, meta, cfg,
                           film, pix, cfg.spp)
        return film["rgb"] / torch.clamp(film["weight"], min=1e-12)[:, None]

    true_base = scene["mat_base"]
    with torch.no_grad():
        target = render_with(true_base)
    base = torch.clamp(true_base + torch.tensor(GUESS_OFFSET, device=dev),
                       0.05, 0.95)
    hist = dict(loss=[], albedo_err=[])
    t0 = time.perf_counter()
    for i in range(args.steps):
        leaf = base.clone().requires_grad_()
        diff = render_with(leaf) - target
        loss = (diff * diff).mean()
        loss.backward()
        with torch.no_grad():
            base = torch.clamp(base - LR * leaf.grad, 0.0, 1.0)
        hist["loss"].append(float(loss.detach()))
        hist["albedo_err"].append(float((base - true_base).abs().max()))
        if not args.quiet and i % 10 == 0:
            print(f"iter {i:3d}  loss {hist['loss'][-1]:.6f}  max albedo err "
                  f"{hist['albedo_err'][-1]:.3f}", flush=True)
    seconds = time.perf_counter() - t0
    if not args.quiet:
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
        print(f"\n{args.steps} steps of {res[0]}x{res[1]} x {args.spp} spp, "
              f"depth {args.depth}, fwd+bwd: {seconds:.2f} s on {where}")
        print("recovered albedos vs truth:")
        for j in range(3):
            print(f"  mat {j}: {base[j].cpu().numpy().round(3)} vs "
                  f"{true_base[j].cpu().numpy().round(3)}")
    hist["seconds"] = seconds
    return hist


if __name__ == "__main__":
    main()
