"""A/B of builds of K1's window walk (csrc/trace2.cu's trace2_window_kernel):
lanes per ray (TRACE2_WINDOW_LANES) x its __launch_bounds__ blocks per SM
(TRACE2_WINDOW_BLOCKS), on the tables and rays path C gives it.

Every build is made with the package's nvcc flags from the current source
(only the two -D flags differ); its window kernels' ptxas lines and blocks
per SM are printed, each case is held to the window=1 walk of the
package's own build (keys and t equal on every lane; any-hit: the
occlusion flags), and then every build is timed on every case in
interleaved rounds, so drift on the card falls on all alike.  Cases: the
faithful San-Miguel analog (`sanmiguel_analog(faithful=True)`, 1080p) with
65,280 bounce rays on its 10.5M-triangle opaque tables (closest at windows
2 and 4, any-hit at window 4) and 65,280 foliage rays on its 240,000-
triangle alpha tables (amask 1 and 2 at window 4, as path C's
PT_WINDOW=4 runs them), all at the main path's pops 4, beside the window=1
walk.  Exits non-zero if a lane differs.  Needs a GPU and nvcc.

Usage (on the card):
    python -m pathtracing_tpu_torch.tools.bench_window \\
        [--builds 16x6 8x4 32x6 16x4] [--rounds 7]
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

from ..accel import cubuild, trace2
from ..scene.intersect import _subset_scene
from ..scenes import sanmiguel_analog
from .bench_trace1 import N_RAYS, _ms, bounce_rays, foliage_rays


def build(lanes: int, blocks: int):
    """(name, library) of trace2.cu with the window walk at `lanes` lanes
    per ray and __launch_bounds__(128, blocks)."""
    defines = {"TRACE2_WINDOW_LANES": lanes, "TRACE2_WINDOW_BLOCKS": blocks}
    return (cubuild.key("trace2", defines),
            trace2.bind(cubuild.load("trace2", defines)))


def cases(dev):
    """(name, tables, origin, direction, t_max, any_hit, amask, window),
    each mode's window=1 case first."""
    scene, _, _ = sanmiguel_analog(resolution=(1920, 1080),
                                   n_tris=10_500_000, foliage=2500,
                                   faithful=True, device=dev)
    alpha = _subset_scene(scene, "pka_")
    ob, db = bounce_rays(scene, N_RAYS)
    of, df = foliage_rays(scene, N_RAYS)
    far = torch.full((N_RAYS,), 1e30, device=dev)
    out = [(f"opaque closest window {w}", scene, ob, db, far, False, 0, w)
           for w in (1, 2, 4)]
    out += [(f"opaque any_hit window {w}", scene, ob, db, far, True, 0, w)
            for w in (1, 4)]
    for am in (1, 2):
        out += [(f"alpha amask{am} window {w}", alpha, of, df, far, False,
                 am, w) for w in (1, 4)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--builds", nargs="+", default=["16x6", "8x4", "32x6",
                                                     "16x4"],
                    metavar="LANESxBLOCKS")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_window: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    specs = [tuple(int(x) for x in b.split("x")) for b in args.builds]
    cubuild.build_all(["trace2"] + [
        ("trace2", {"TRACE2_WINDOW_LANES": w, "TRACE2_WINDOW_BLOCKS": b})
        for w, b in specs])
    trace2.build_kernel()
    libs = dict(build(w, b) for w, b in specs)
    all_cases = cases(dev)
    smem = trace2.staged_bytes(all_cases[0][1])
    for name, lib in libs.items():
        for fn, line in cubuild.kernel_resources(name):
            if "window" in fn:
                print(f"[ptxas] {name} {fn}: {line}", flush=True)
        occ = {m: trace2.occupancy(m, window=True, smem=smem, lib=lib)
               for m in ("closest", "any_hit", "amask1", "amask2")}
        print(f"[occupancy] {name}: window kernel blocks of 128 per SM "
              f"{occ} with {smem} B staged", flush=True)

    def run(lib, tabs, o, d, tm, any_hit, amask, window):
        return trace2._launch_kernel(tabs, o, d, tm, any_hit, False, amask,
                                     host_lib=lib, window=window,
                                     pops=4)[:2]

    bad = 0
    for case, tabs, o, d, tm, any_hit, amask, window in all_cases:
        if window == 1:
            bt, bk = run(None, tabs, o, d, tm, any_hit, amask, 1)
            continue
        for name, lib in libs.items():
            t, k = run(lib, tabs, o, d, tm, any_hit, amask, window)
            diff = int(((k >= 0) != (bk >= 0)).sum() if any_hit
                       else ((k != bk) | (t != bt)).sum())
            bad += diff
            print(f"[parity] {case} {name} vs window=1: lanes "
                  f"differing {diff} of {N_RAYS} (hits "
                  f"{int((bk >= 0).sum())})", flush=True)
    samples = {}
    for _ in range(args.rounds):
        for case, tabs, o, d, tm, any_hit, amask, window in all_cases:
            for name, lib in (libs.items() if window > 1
                              else [("package build", None)]):
                samples.setdefault((case, name), []).append(_ms(
                    lambda: run(lib, tabs, o, d, tm, any_hit, amask,
                                window)))
    for (case, name), v in samples.items():
        med = statistics.median(v)
        print(f"[time] {case} {name}: median {med:.4f} ms of {args.rounds} "
              f"interleaved rounds, spread {(max(v) - min(v)) / med:.2%}",
              flush=True)
    print(f"[result] lanes differing {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
