"""What the reference's instanced scan (rtbench/reference/iscan.py) costs
on a production-scale instanced scene: one check iteration's lanes over a
synthetic field of many instances of one large model.

    python3 rtbench/tools/iscan_cost.py --instances 100000 \\
        --model-tris 100000 --lanes 64 --seed 7 --out iscan.json

The model is a canopy of small random triangles in a unit ball; the
instances stand on a square grid with a jitter, each turned about the
vertical and scaled by 0.8-2.2, as the courtyard's shrubs are.  Two sets
of `lanes` rays are scanned: camera rays from above the field's corner
down into it, reaching to the ground plane (what a closest-hit check
scans: up to the program's hit), and shadow rays from points on the
ground toward a low sun, unbounded (every instance on the way).  Prints,
and writes to --out, the scan's build time, each set's time, the (ray,
instance) pairs and triangle tests it made, and the device's peak
memory.  Needs the card (it prints the device it ran on).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench.reference.iscan import InstScan  # noqa: E402
from rtbench.reference.scan import BIG  # noqa: E402


def field(n_inst, model_tris, seed, device):
    """The synthetic description's tables (otri_v, inst_*) and the field's
    side."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn((model_tris, 1, 3), generator=g, device=device)
    c = c / c.norm(dim=-1, keepdim=True).clamp(min=1e-6) \
        * torch.rand((model_tris, 1, 1), generator=g, device=device) ** (1 / 3)
    v = c + 0.04 * (torch.rand((model_tris, 3, 3), generator=g,
                               device=device) - 0.5)
    v[..., 1] += 1.0                          # the canopy stands on y = 0
    side = math.ceil(math.sqrt(n_inst))
    spacing = 3.0
    k = torch.arange(n_inst, device=device)
    pos = torch.stack([(k % side).double(), torch.zeros_like(k).double(),
                       (k // side).double()], 1) * spacing
    pos[:, [0, 2]] += (torch.rand((n_inst, 2), generator=g, device=device,
                                  dtype=torch.float64) - 0.5) * spacing
    rot = torch.rand(n_inst, generator=g, device=device,
                     dtype=torch.float64) * math.pi
    s = 0.8 + 1.4 * torch.rand(n_inst, generator=g, device=device,
                               dtype=torch.float64)
    m = torch.zeros((n_inst, 4, 4), dtype=torch.float64, device=device)
    m[:, 0, 0], m[:, 0, 2] = torch.cos(rot) * s, torch.sin(rot) * s
    m[:, 1, 1] = s
    m[:, 2, 0], m[:, 2, 2] = -torch.sin(rot) * s, torch.cos(rot) * s
    m[:, :3, 3] = pos
    m[:, 3, 3] = 1.0
    inv = torch.linalg.inv(m)
    scene = dict(otri_v=v.float(), inst_fwd=m[:, :3].float(),
                 inst_inv=inv[:, :3].float(),
                 inst_base=torch.zeros(n_inst, dtype=torch.int32,
                                       device=device),
                 inst_count=torch.full((n_inst,), model_tris,
                                       dtype=torch.int32, device=device))
    return scene, side * spacing


def rays(lanes, extent, seed, device):
    g = torch.Generator(device=device).manual_seed(seed + 1)
    # camera rays: from above a corner of the field down into it, to y = 0
    eye = torch.tensor([-10.0, 40.0, -10.0], device=device)
    aim = torch.rand((lanes, 3), generator=g, device=device) * extent
    aim[:, 1] = 0.0
    d = aim - eye
    cam = (eye.expand(lanes, 3).contiguous(), d / d.norm(dim=-1,
                                                        keepdim=True),
           d.norm(dim=-1))
    # shadow rays: from the ground toward a low sun, unbounded
    o = torch.rand((lanes, 3), generator=g, device=device) * extent
    o[:, 1] = 0.05
    sun = torch.tensor([0.6, 0.35, 0.7], device=device)
    sh = (o, (sun / sun.norm()).expand(lanes, 3).contiguous(),
          torch.full((lanes,), BIG, device=device))
    return dict(camera=cam, shadow=sh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", type=int, default=100_000)
    ap.add_argument("--model-tris", type=int, default=100_000)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("iscan_cost: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    scene, extent = field(args.instances, args.model_tris, args.seed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    scan = InstScan(scene)
    torch.cuda.synchronize()
    res = dict(device=torch.cuda.get_device_name(0),
               instances=args.instances, model_tris=args.model_tris,
               lanes=args.lanes, build_s=time.perf_counter() - t)
    for name, (o, d, tm) in rays(args.lanes, extent, args.seed, dev).items():
        scan.tri_tests = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        ray = scan.hits(o, d, tm)[0]
        torch.cuda.synchronize()
        res[name] = dict(seconds=time.perf_counter() - t,
                         pairs=int(scan.pairs(o, d, tm)[0].numel()),
                         tri_tests=int(scan.tri_tests), hits=int(ray.numel()))
    res["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
