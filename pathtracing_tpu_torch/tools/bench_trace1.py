"""A/B of builds of the single-level traversal kernel K2 (csrc/trace1.cu):
lanes per ray (TRACE1_LANES) x the kernel's __launch_bounds__, on the
tables and rays the main path gives it.

Every build is made with the package's nvcc flags from the current source
(only the launch-bounds line and -DTRACE1_LANES differ), its ptxas lines
and blocks per SM are printed, it is held to the plain version (keys and
t equal on every lane, any-hit: the occlusion flags) and then all builds
are timed in interleaved rounds, each round timing every build on every
case in turn, so drift on the card falls on all alike.  Cases: path B's
tables (`sanmiguel_analog(n_tris=60_000, foliage=600)`, 1080p) with 65,280
bounce rays (closest, any-hit) and foliage rays (amask 1 / 2), a soup of
300 run-time instances over 20K world triangles and a moving 60K-triangle
soup with shell rays (closest, any-hit).  Exits non-zero if a lane
differs.  Needs a GPU and nvcc.

Usage (on the card):
    python -m pathtracing_tpu_torch.tools.bench_trace1 \\
        [--lanes 8 16] [--bounds 128 "128, 4"] [--rounds 7]
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..accel import cubuild, trace1
from ..scene.intersect import _first_block_key, _subset_scene
from ..scenes import _sm_height, sanmiguel_analog

N_RAYS = 65_280          # 34 rows of 1920: the render's dispatch width
_BOUNDS = "__launch_bounds__(128)\ntrace1_kernel("


def build(lanes, bounds, out_dir):
    """The ctypes library of csrc/trace1.cu at `lanes` lanes per ray and
    `__launch_bounds__(bounds)`, with its ptxas output."""
    src = cubuild._inlined(cubuild.source("trace1"))
    if src.count(_BOUNDS) != 1:
        raise RuntimeError("trace1.cu: the kernel's launch bounds not found")
    name = f"trace1_w{lanes}_lb{bounds.replace(', ', '_')}"
    cu = Path(out_dir) / f"{name}.cu"
    cu.write_text(src.replace(_BOUNDS, f"__launch_bounds__({bounds})\n"
                                       "trace1_kernel("))
    so = cu.with_suffix(".so")
    res = subprocess.run([cubuild._nvcc(), *cubuild._NVCC_FLAGS,
                          f"-DTRACE1_LANES={lanes}", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    cubuild.BUILD_LOG[name] = res.stdout + res.stderr
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    return name, trace1.bind(ctypes.CDLL(str(so)))


def _sorted(scene, o, d):
    perm = torch.argsort(_first_block_key(scene, o, d), stable=True)
    return o[perm].contiguous(), d[perm].contiguous()


def bounce_rays(scene, n, seed=2):
    """Random off-surface origins low in the scene box, downward
    directions, in the dispatch's key order."""
    rng = np.random.default_rng(seed)
    lo = scene["scene_lo"].cpu().numpy()
    hi = scene["scene_hi"].cpu().numpy()
    o = np.stack([rng.uniform(lo[0], hi[0], n),
                  rng.uniform(lo[1] * 0.9 + hi[1] * 0.1,
                              lo[1] * 0.7 + hi[1] * 0.3, n),
                  rng.uniform(lo[2], hi[2], n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dev = scene["pk_tri"].device
    return _sorted(scene, torch.from_numpy(o).to(dev),
                   torch.from_numpy(d).to(dev))


def foliage_rays(scene, n, seed=5):
    """Origins up to 2.5 above the courtyard's terrain, directions uniform
    on the sphere, in the dispatch's key order."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(3.0, 97.0, n).astype(np.float32)
    z = rng.uniform(3.0, 97.0, n).astype(np.float32)
    y = _sm_height(x, z) + rng.uniform(0.05, 2.5, n).astype(np.float32)
    o = np.stack([x, y, z], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dev = scene["pk_tri"].device
    return _sorted(scene, torch.from_numpy(o).to(dev),
                   torch.from_numpy(d).to(dev))


def _soup(rng, n, spread=60.0, size=1.5):
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return np.stack([v0, v0 + rng.normal(0, size, (n, 3)),
                     v0 + rng.normal(0, size, (n, 3))], 1).astype(np.float32)


def _affine(rng):
    a = rng.uniform(0, np.pi)
    lin = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]) \
        @ np.diag(rng.uniform(0.5, 2.0, 3))
    lin[0, 1] += 0.3
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = rng.uniform(-50, 50, 3)
    return m.astype(np.float32)


def cases(dev):
    """(name, tables, origin, direction, t_max, any_hit, amask, time)."""
    scene, _, _ = sanmiguel_analog(resolution=(1920, 1080), n_tris=60_000,
                                   foliage=600, faithful=True, device=dev)
    alpha = _subset_scene(scene, "pka_")
    ob, db = bounce_rays(scene, N_RAYS)
    of, df = foliage_rays(scene, N_RAYS)
    far = torch.full((N_RAYS,), 1e30, device=dev)
    rng = np.random.default_rng(29)
    ov = np.concatenate([_soup(rng, 96, 3.0, 1.0), _soup(rng, 200, 4.0, 1.0)])
    fw = [_affine(rng) for _ in range(300)]
    iv = [np.linalg.inv(f).astype(np.float32) for f in fw]
    inst, _ = trace1.build_tri_blocks_inst(
        _soup(rng, 20_000), ov, [f[:3, :4] for f in fw],
        [f[:3, :4] for f in iv], [0] * 200 + [96] * 100,
        [96] * 200 + [200] * 100)
    mv = _soup(rng, 60_000)
    mot, _ = trace1.build_tri_blocks(
        mv, tri_vel=rng.normal(0, 3.0, mv.shape[:1] + (3,)).astype(
            np.float32), shutter=(0.0, 1.0))
    inst, mot = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in t.items()} for t in (inst, mot))
    times = torch.from_numpy(rng.uniform(0, 1, N_RAYS).astype(
        np.float32)).to(dev)
    o = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 120.0
    d = rng.uniform(-60, 60, (N_RAYS, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    so, sd = (torch.from_numpy(x).to(dev) for x in (o, d))
    big = torch.full((N_RAYS,), 3e38, device=dev)
    return [("path B closest", scene, ob, db, far, False, 0, None),
            ("path B any_hit", scene, ob, db, far, True, 0, None),
            ("path B amask1", alpha, of, df, far, False, 1, None),
            ("path B amask2", alpha, of, df, far, False, 2, None),
            ("instanced soup closest", inst, so, sd, big, False, 0, None),
            ("instanced soup any_hit", inst, so, sd, big, True, 0, None),
            ("moving soup closest", mot, so, sd, big, False, 0, times),
            ("moving soup any_hit", mot, so, sd, big, True, 0, times)]


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--bounds", nargs="+",
                    default=["128", "128, 4", "128, 6", "128, 8"])
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_trace1: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    out = tempfile.mkdtemp(prefix="bench_trace1_")
    libs = dict(build(w, b, out) for w in args.lanes for b in args.bounds)
    all_cases = cases(dev)
    for name, lib in libs.items():
        for fn, line in cubuild.kernel_resources(name):
            print(f"[ptxas] {name} {fn}: {line}", flush=True)
        occ = {m: trace1.occupancy(m, trace1.staged_bytes(all_cases[0][1]),
                                   lib=lib)
               for m in ("closest", "amask1", "amask2", "inst_closest",
                         "motion_closest")}
        print(f"[occupancy] {name}: blocks of 128 per SM {occ}", flush=True)

    def run(lib, tabs, o, d, tm, any_hit, amask, tme):
        return trace1._launch_kernel(tabs, o, d, tm, any_hit, False, amask,
                                     tme, host_lib=lib)[:2]

    bad = 0
    for case, tabs, o, d, tm, any_hit, amask, tme in all_cases:
        pt, pk = trace1._plain_slots(tabs, o, d, tm, amask=amask, time=tme)
        for name, lib in libs.items():
            t, k = run(lib, tabs, o, d, tm, any_hit, amask, tme)
            diff = int(((k >= 0) != (pk >= 0)).sum() if any_hit
                       else ((k != pk) | (t != pt)).sum())
            bad += diff
            print(f"[parity] {case} {name}: lanes differing {diff} of "
                  f"{N_RAYS} (hits {int((pk >= 0).sum())})", flush=True)
    samples = {}
    for _ in range(args.rounds):
        for case, tabs, o, d, tm, any_hit, amask, tme in all_cases:
            for name, lib in libs.items():
                samples.setdefault((case, name), []).append(_ms(
                    lambda: run(lib, tabs, o, d, tm, any_hit, amask, tme)))
    for (case, name), v in samples.items():
        med = statistics.median(v)
        print(f"[time] {case} {name}: median {med:.4f} ms of {args.rounds} "
              f"interleaved rounds, spread {(max(v) - min(v)) / med:.2%}",
              flush=True)
    print(f"[result] lanes differing {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
