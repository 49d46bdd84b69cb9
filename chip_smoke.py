#!/usr/bin/env python3
"""Smoke run of pathtracing_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the JSON
device summary only when every phase passed):
  1. build the three CUDA sources (csrc/trace2.cu, the two-level traversal
     K1, csrc/trace1.cu, the single-level traversal K2, and csrc/leaf.cu,
     the leaf micro-benchmark K4), one nvcc each, started together; print
     each instance's registers, stack frame and spills, and K1's (group
     and window kernels) and K2's blocks per SM
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) unstaged;
  2. hold every kernel mode against its plain PyTorch version on the card,
     no flip allowed:
     a. K1 and K2 closest hit and any-hit on a 200K-triangle soup (K2: cut
        to 65,536 triangles, its size) with 64K rays, against the brute
        force over every table slot;
     b. the alpha micro-mask modes (amask 1 and 2) of K1 and K2 on a soup
        of alpha-cutout cards (masks from the scene's leaf texture) with
        65,280 rays, against the same brute force;
     c. K1 closest hit and any-hit on the 10.5M-triangle San-Miguel-analog
        tables with 65,280 bounce-like rays (the render's dispatch width)
        against the plain version culled by child box, after checking
        that every child box holds its triangles; kernel and plain times
        and the kernel's bound from its counters (tools/roofline.py);
     [bvh] then the accel="bvh" backend (accel/build.build_bvh over the
        same 10.5M triangles, accel/traverse.bvh_intersect, plain
        PyTorch) closest and any-hit on the same rays against K1: valid
        equal, t to rtol=1e-5, triangles equal but on shared edges; build
        seconds, each dispatch's time and loop iterations; then the CLI's
        --accel bvh on a 4,802-triangle OBJ, card against CPU by the 99%
        rule, and one 960x540 1-spp depth-8 frame of it;
     d. (after phase 5's scene build) K1 amask 1 and 2 on the faithful
        scene's full alpha tables (240,000 foliage triangles) with 65,280
        rays through the foliage, the same way; the share of lanes mode 1
        culled and mode 2 resolved as `solid` must both be > 0; then the
        window walk as path C runs it there (windows 2 / 4 at pops 4,
        amask 1 and 2) against the window=1 walk and the plain walk, with
        its times beside the window=1 walk's and its bounds;
     e. synthetic instanced and moving soups (300 sheared, non-uniformly
        scaled instances of two models over world triangles; random
        velocities and ray times): K1 instanced closest / any-hit, K1
        motion, K1 instanced + motion, K2 instanced, K2 motion, against
        the brute force on 8,192 rays and the culled plain version on
        65,280;
     f. (after phase 6's scene build) K1 instanced amask 1 and 2 on the
        run-time-instanced foliage's real alpha tables (2,500 expanded
        L1s over one stored shrub) with foliage rays;
     g. (after phase 7's scene build) K2 closest / any-hit on the small
        courtyard's real opaque tables with bounce rays and K2 amask 1 /
        2 on its alpha tables with foliage rays;
  3. card numerics against the port's CPU numerics, which the CPU tests
     hold to the JAX package: small renders (the untextured and the
     faithful San-Miguel analog, the Cornell box, the textured quad, a
     scene of run-time instances, a moving mesh, a moving instance) must
     agree on more than 99% of pixel values to rtol=1e-4, atol=1e-5 (the
     faithful miniature at depth 2: its normal map amplifies one-ulp
     differences, so its depth-4 agreement is printed, not held), the
     shadow predicate on ~8K rays through the foliage of the small
     faithful scene, flattened and with run-time-instanced foliage, must
     be equal lane for lane (MASK mode is deterministic), and, with
     integrator="volpath", spheres_medium and a medium bounded by a
     4,992-triangle mesh (through K2, and through K1 with TWOLEVEL_MIN = 0
     and PT_WINDOW=2) must agree like the other small renders;
  4. the legacy path: sanmiguel_analog(faithful=False) at 1920x1080, path
     tracing, depth 32, 1 spp, regenerate=True, one frame through the
     bench's bench_mesh_forward (render() at sample_offset 1, one timed
     repetition, no warm frame: every frame below goes the same way,
     through the bench's bench_frame); launches > 0, image finite with a
     positive mean;
  5. the faithful path: sanmiguel_analog(faithful=True) (10.5M terrain +
     240,000 alpha foliage triangles flattened to world triangles,
     textures, normal map, glass, metal, lamp meshes) at 1920x1080, depth
     64, 1 spp, regenerate=True, one frame; K1's launch
     counts over the frame must be > 0 in its four plain modes; with
     --sections, one more frame with a timer around each section of the
     bounce loop; with --profile, one more frame under torch.profiler;
  6. path A: the same scene with its 2,500 shrubs kept as run-time
     instances (PT_FLATTEN_MAX=0), depth 32 (cut from 64 for the
     script's time), one frame: K1 closest
     and any-hit on the plain opaque tables, K1 instanced amask 1 / 2 on
     the alpha tables; its rays per sample and image mean must land
     within 2% of phase 5's and of path C's (the same depth);
  7. path B: sanmiguel_analog(n_tris=60,000, foliage=600), depth 32,
     one frame: K2 in its four plain modes;
     h. (after phase 5's frame) K1's new modes on the faithful scene's
        10.5M-triangle opaque tables with 65,280 bounce rays: the schedules
        (window 2 / 4 with pops = 2 * window, pair, pops 1 / 4) against the
        window=1, pops=1 walk, the visit caps 1 / 2 / 16 with their
        frontier outputs against the plain capped walk (the same two
        checks run on the 200K soup against the brute force, on the
        instanced and moving soups and on path A's instanced alpha
        tables), the multipass driver (caps 16, 8, 8 then uncapped) against
        one pass, the new modes' times and bounds, and K1 closest on the
        same bounce rays in the order drawn against the dispatch's key
        order (times, counters, the un-permuted results equal);
  5b. path C: the faithful frame again, at depth 32 (cut from 64 for
     the script's time), under PT_MULTIPASS=16,8,8 and PT_WINDOW=4 (the
     multipass driver on the mask-free opaque passes, the window walk on
     the alpha passes); its rays per sample and image mean must land
     within 2% of phase 5's, its iterations are printed beside them;
  5c. [grad] gradients through the renderer: (a) on tests/test_regen_diff.py's
     scene with a textured floor at 96x72, depth 5, the mat_base and texel
     gradients of the regenerating form (trace_regen_diff) and the scan
     form on the card against the port's CPU gradients, relative max-abs
     error <= GRAD_REL_TOL, and the card's gradients of another sampler
     seed must read above it (the gate tells a fault); (b) the faithful
     frame (still phase 5's scene) fwd+bwd with respect to mat_base
     (tools/bench_grad.py): the regenerating form at depth 8 (the whole
     frame) and 64 (its first queue group, for the script's time; 65,536
     lanes) and the scan form at depth 8 with compact_after=3, one
     timed run each, with samples/s, the fwd+bwd / plain forward ratio,
     peak memory, bytes kept per lane per iteration, the forward / backward
     split, K1 / K2 launches forward and backward (the backward
     must launch none), finite nonzero gradients, and the recording
     forward's radiance bit-equal to trace_regen's (every queue group at
     depth 8, the first at depth 64); with --sections, both regenerating
     forms once more over the whole frame with a timer around each section
     of the backward; the depth-8 runs go through the bench's
     bench_mesh_fwd_bwd_regen / _frame (one timed run, no warm run);
  5d. [bench] the bench's rows no frame above runs, on the faithful scene:
     its rays run (one run, its rays per sample beside the faithful
     frame's), its bounce-kernel row (K1 per 65,536-ray dispatch, per-ray
     counters, bound) and its Cornell frame at CORNELL_SPP samples; then
     these rows with the frames' and [grad]'s as one JSON object under
     this script's own labels (each row one run, so not the bench's line);
  8. path D: spheres_medium at 1920x1080, integrator="volpath", depth 32,
     1 spp, regenerate=True (its own five analytic prims: no kernel; the
     volpath kernel launches come from phase 3's small renders of a medium
     bounded by a 4,992-triangle mesh, through K2 and through K1);
  8b. [cli] the command line and what it reaches: (1) writes
     sanmiguel_analog(faithful=False)'s geometry (10.5M triangles, two
     diffuse materials as factors, no image) as a .glb; (2) runs
     `pathtracing_tpu_torch.__main__.main(["render", "--model", <glb>,
     "--cache", <npz>, ...])` at 1920x1080, 1 spp, depth 32, --regen,
     --env-light 0.35 --sun 3 and the legacy camera, printing the import,
     build, cache-save and render seconds, RenderTimer's JSON line, K1's
     launches in the frame (> 0) and accel; (3) runs it again from the
     cache: the film must be bit-equal, the cache-load seconds printed
     beside the build's; (4) renders the same model lit by a 2048x1024
     HDR sky (io/hdr.write_hdr, add_env_light_from_file: 1024x512 tables)
     through the bench's bench_frame at 1920x1080, depth 32: finite, mean
     > 0, its seconds and rays per sample; (5) holds the card to the CPU by the
     99% rule on a 4,802-triangle OBJ through the native parser (K2, then
     K1 under PT_TWOLEVEL_MIN=0), a glTF with an emissive-textured quad
     (texture through the builder's pool) and a function light with an
     env map, resumes an interrupted --checkpoint run bit-equal to one
     uninterrupted run and prints --adaptive's mean spp; (6) holds
     render_sharded on a one-rank nccl group to render() (rtol=2e-4,
     atol=2e-5).  The .glb, the cache and the sky are deleted after;
  8c. [oracle] tests/independent_oracle.py (a NumPy tracer that shares no
     code with the port) held to the port at the JAX oracle test's full
     settings (tests/test_torch_independent_oracle.py's FULL: 32x32,
     depth 4, 512 spp, sampler seeds 17 / 11, oracle generators 303 /
     101, oracle spp 512 / 768), for `path` and `simple`: the oracle runs
     once per integrator in a spawned worker on the host's CPU while the
     card renders (a) the test's scene (analytic prims: brute, no
     kernel), (b) its floor as a 16x16-cell mesh of 512 triangles over
     the same quad with accel="pallas" (K2; launches > 0), (c) (b) built
     under PT_TWOLEVEL_MIN=0 (K1; launches > 0), each drained by the
     regenerating tracer with 65,536 lanes in flight (render() would give
     this frame 1,024); each holds the whole-image mean within 2% and
     every 4x4 block brighter than 0.05 within 12% of the oracle's;
  8d. [example] the API walkthrough: tools/example_1.main at 320x240, 16
     spp, volpath depth 8 (its seven analytic prims: no kernel): seconds,
     samples/s, mean (finite, > 0); then its build_scene at 48x36, 4 spp
     under its own config card against CPU by the 99% rule;
  9. K4 (csrc/leaf.cu, tools/bench_leaf.py): every mode against its plain
     version at n_iter=16 (the scalar modes at every lane count), then the
     JAX tool's defaults (K2=256, n_iter=2000) in ROUNDS interleaved rounds
     (the scalar modes at every lane count: the lanes A/B) with
     microseconds per child test and the error against vpu, the plain
     versions' and the library product's times, and each mode's bound on
     the card and on the one SM its block runs on;
  10. print the kernel table JSON, the card's name and power limit, and
     the device summary.
Every K1 mode is timed at pops 1 ("ms") and at the main path's pops 4
("ms_pops4").  Every K1, K2 and K4 row is timed in ROUNDS interleaved
rounds, each round timing every mode of the phase in turn: "ms" is the
median, "ms_spread" (max - min) / median.
Writes chiprun_out/sanmiguel_{legacy,faithful,multipass,tlas,small}.ppm,
chiprun_out/spheres_medium.ppm, chiprun_out/cli_{legacy,hdr}.ppm,
chiprun_out/example_1.ppm,
chiprun_out/bvh/*.ppm and the whole output to chiprun_out/chip_smoke.log,
each line there after the seconds since the start.

The script imports nothing of JAX.  Tolerances: a kernel and its plain
version share the arithmetic (the kernels are built without FMA
contraction) and both break ties in t by the least table slot (instanced
tables: the least expanded block, then the least offset), and the amask=2
contract does not depend on visit order, so `valid`, `tri`, `inst` and
`solid` must agree exactly (no flip allowed) and `t` to rtol=1e-5.  In
any-hit mode `tri` is whichever occluder the traversal found first, so
only `valid` is compared, and every reported occluder of a plain table is
checked to be hit.
"""
from __future__ import annotations

import dataclasses
import json
import math
import struct
import subprocess
import sys
import time
from pathlib import Path

RES = (1920, 1080)          # both paths: San-Miguel analog at 1080p,
N_TRIS = 10_500_000         # 10.5M-triangle terrain;
DEPTH = 32                  # the legacy path's depth,
DEPTH_FAITHFUL = 64         # the faithful path's,
# cut from 64 so the whole script, [bvh] and [bench] included, stays
# inside its limit on a slow host
DEPTH_AC = 32               # paths A and C
DEPTH_BD = 32               # paths B and D
FOLIAGE = 2500              # shrub instances (96 alpha triangles each)
N_TRIS_SMALL = 60_000       # path B: the courtyard at the size of one
FOLIAGE_SMALL = 600         # imported model, on the single-level kernel
# (the fp32 peak, the HBM rate and the per-test counts of the traversal
# bounds are tools/roofline.py's)
TF32_PEAK = 495e12          # H100 SXM dense TF32 tensor-core FLOP/s
BF16_PEAK = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
MXU_POST_FLOPS = 14         # K4: post-processing of one (ray, triangle) pair
N_SM = 132                  # H100 SXM SMs (K4's one block runs on one)
MULTIPASS = (16, 8, 8)      # path C's PT_MULTIPASS schedule
LEAF_K2, LEAF_ITERS = 256, 2000    # K4's defaults (the JAX tool's)
LIB_CALLS = 10              # K4's library product: x 20 calls per sample
GRAD_PROBE_RES = (96, 72)   # [grad] a: card against CPU gradients
# card against CPU gradients, relative max-abs error: sound readings are
# ~2e-7; the gradient of other samples (sampler seed 10 for 9), a fault
# that decorrelates every path, reads ~2e-2 (both printed each run)
GRAD_REL_TOL = 1e-4
GRAD_SCAN_DEPTH = 8         # [grad] b: the scan form's depth and tail
GRAD_COMPACT = 3            # compaction (bench.py's BENCH_BWD_COMPACT)
BVH_RES = (960, 540)        # [bvh]: the CLI frame's resolution
CORNELL_SPP = 4             # [bench]: the Cornell frame's samples (the
                            # bench's own run takes 32)
# K1 schedules held against the window=1, pops=1 walk (results must not
# change) and the visit caps held against the plain capped walk
SCHEDULES = (dict(window=2, pops=4), dict(window=4, pops=8),
             dict(pair=True), dict(pops=1), dict(pops=4))
CAPS = (1, 2, 16)
ROUNDS = 7                  # interleaved timing rounds of a phase's rows
ORACLE_FLOOR_CELLS = 16     # [oracle] (b), (c): the floor as 16x16 cells
ORACLE_LANES = 1 << 16      # [oracle]: lanes in flight, the main path's
EXAMPLE_RES = (320, 240)    # [example]: the walkthrough's card frame
EXAMPLE_SPP = 16


def _sync_time(fn, reps=20):
    """ms per call of fn(): one warm call, then `reps` calls back to back
    on the current stream between two CUDA events (one sample)."""
    import torch
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


def _time_rounds(fns):
    """Interleaved timing of a phase's kernel rows: ROUNDS rounds, each
    taking one _sync_time sample of every fn of `fns`
    ({key: fn}) in turn, so drift on the card falls on every row alike.
    Returns {key: (median ms, spread)}, spread = (max - min) / median of
    the samples: a difference between two rows under their spreads is
    noise."""
    import statistics
    samples = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, fn in fns.items():
            samples[k].append(_sync_time(fn))
    out = {}
    for k, v in samples.items():
        med = statistics.median(v)
        out[k] = (med, (max(v) - min(v)) / med)
    return out


def _fns(mod):
    """(kernel wrapper, plain version) of a traversal module."""
    if hasattr(mod, "tri_intersect2"):
        return mod.tri_intersect2, mod.tri_intersect2_plain
    return mod.tri_intersect1, mod.tri_intersect1_plain


def _compare(mod, scene, o, d, t_max, label, prune, **kw):
    """Kernel vs plain version (culled by box, or the brute force over
    every slot); kw: time.  Returns {"closest": (max_abs_err of t, ms of
    the plain version's call), "any_hit": (max abs difference of the
    occlusion flags, ms of the plain version's any_hit call)}."""
    import torch
    kernel, plain = _fns(mod)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = plain(scene, o, d, t_max, prune=prune, **kw)
    b.record()
    # the brute force is one function for both modes: not run twice
    ref_any = plain(scene, o, d, t_max, any_hit=True, prune=True, **kw) \
        if prune else ref
    c = torch.cuda.Event(enable_timing=True)
    c.record()
    got = kernel(scene, o, d, t_max, **kw)
    anyh = kernel(scene, o, d, t_max, any_hit=True, **kw)
    torch.cuda.synchronize()
    n = o.shape[0]
    flips = int((got["valid"] != ref["valid"]).sum())
    both = got["valid"] & ref["valid"]
    tri_diff = int((both & ((got["tri"] != ref["tri"])
                            | (got["inst"] != ref["inst"]))).sum())
    same = both & (got["tri"] == ref["tri"]) & (got["inst"] == ref["inst"])
    t_bad = int((same & ~torch.isclose(got["t"], ref["t"], rtol=1e-5,
                                       atol=0.0)).sum())
    err = float((got["t"] - ref["t"]).abs()[same].max()) if same.any() \
        else 0.0
    any_flips = int((anyh["valid"] != ref_any["valid"]).sum())
    # every any-hit occluder must really be hit within t_max
    v = anyh["valid"]
    tv = scene["tri_v"] if "tri_v" in scene else None
    occl_bad = 0
    if tv is not None and v.any() and kw.get("time") is None \
            and "pk_blk_src" not in scene:
        idx = torch.nonzero(v)[:, 0]
        tri = tv[anyh["tri"][idx]]
        t = _ray_tri_t(o[idx], d[idx], tri)
        occl_bad = int((~((t >= 1e-5) & (t < t_max[idx]))).sum())
    plain_ms, plain_any_ms = a.elapsed_time(b), b.elapsed_time(c)
    any_txt = f", any-hit {plain_any_ms:.1f} ms" if prune else ""
    print(f"[compare] {label} vs {'culled' if prune else 'brute'} plain "
          f"({plain_ms:.1f} ms{any_txt}): rays={n} hits={int(ref['valid'].sum())} "
          f"(on instances {int((ref['inst'] >= 0).sum())}) "
          f"closest: valid_flips={flips} tri_or_inst_mismatch={tri_diff} "
          f"t_outside_rtol={t_bad} max_abs_err_t={err:.3e} | any-hit: "
          f"valid_flips={any_flips} bad_occluders={occl_bad}", flush=True)
    if flips or tri_diff or t_bad or any_flips or occl_bad:
        raise RuntimeError(f"kernel disagrees with its plain version on "
                           f"{label}")
    return {"closest": (err, plain_ms),
            "any_hit": (float(any_flips), plain_any_ms)}


def _compare_amask(mod, scene, o, d, t_max, label, prune, **kw):
    """Kernel vs plain version in the alpha micro-mask modes.  Returns
    {mode: (max_abs_err of t, plain ms, share culled or solid)}."""
    import torch
    kernel, plain = _fns(mod)
    n = o.shape[0]
    base = kernel(scene, o, d, t_max, **kw)
    out = {}
    for amask in (1, 2):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = plain(scene, o, d, t_max, prune=prune, amask=amask, **kw)
        b.record()
        got = kernel(scene, o, d, t_max, amask=amask, **kw)
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        flips = int((got["valid"] != ref["valid"]).sum())
        tri_diff = int(((got["tri"] != ref["tri"])
                        | (got["inst"] != ref["inst"])).sum())
        same = got["valid"] & ref["valid"] & (got["tri"] == ref["tri"])
        t_bad = int((same & ~torch.isclose(got["t"], ref["t"], rtol=1e-5,
                                           atol=0.0)).sum())
        err = float((got["t"] - ref["t"]).abs()[same].max()) if same.any() \
            else 0.0
        solid_flips = 0
        if amask == 2:
            solid_flips = int((got["solid"] != ref["solid"]).sum())
            share = float(ref["solid"].float().mean())
            what = f"solid_flips={solid_flips} solid share={share:.4f} " \
                   f"mixed candidates={int(ref['valid'].sum())}"
        else:
            # lanes whose unmasked nearest hit was dropped as transparent
            culled = base["valid"] & (~ref["valid"]
                                      | (ref["tri"] != base["tri"]))
            share = float(culled.float().mean())
            what = f"culled share={share:.4f}"
        print(f"[compare] {label} amask={amask} vs "
              f"{'culled' if prune else 'brute'} plain ({plain_ms:.1f} ms): "
              f"rays={n} unmasked hits={int(base['valid'].sum())} "
              f"hits={int(ref['valid'].sum())} valid_flips={flips} "
              f"tri_or_inst_mismatch={tri_diff} t_outside_rtol={t_bad} "
              f"max_abs_err_t={err:.3e} {what}", flush=True)
        if flips or tri_diff or t_bad or solid_flips:
            raise RuntimeError(f"kernel (amask={amask}) disagrees with its "
                               f"plain version on {label}")
        out[amask] = (err, plain_ms, share)
    return out


def _ray_tri_t(o, d, tri):
    """Per-ray Moller-Trumbore against one triangle each (t, or -1 on a
    miss); the occluder check of the any-hit comparison."""
    import torch
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    h = torch.cross(d, e2, dim=-1)
    det = (e1 * h).sum(-1)
    inv = 1.0 / torch.where(det.abs() < 1e-9, 1.0, det)
    s = o - tri[:, 0]
    u = (s * h).sum(-1) * inv
    q = torch.cross(s, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = ((det.abs() >= 1e-9) & (u >= -1e-6) & (v >= -1e-6)
          & (u + v <= 1 + 1e-6))
    return torch.where(ok, t, -1.0)


def _bounce_rays(scene, n, seed=2, sort=True):
    """Bounce-like rays: random off-surface origins in the lower part of
    the scene box, downward-hemisphere directions, sorted by first entered
    block as the dispatch sorts them (sort=False: in the order drawn)."""
    import numpy as np
    import torch
    from pathtracing_tpu_torch.scene.intersect import _first_block_key
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
    o = torch.from_numpy(o).to(dev)
    d = torch.from_numpy(d).to(dev)
    if not sort:
        return o, d
    perm = torch.argsort(_first_block_key(scene, o, d), stable=True)
    return o[perm].contiguous(), d[perm].contiguous()


def _key_order(scene, n, label):
    """K1 closest (at the main path's pops 4) on the same bounce rays in
    caller order (as drawn: no coherence between neighbours) and in the
    dispatch's order (sorted by _first_block_key), timed in interleaved
    rounds beside the key itself, with each order's per-ray counters; the
    sorted result, un-permuted, must equal the caller-order one on every
    lane.  Says what the sort key buys the group walk."""
    import torch
    from pathtracing_tpu_torch.accel import trace2
    from pathtracing_tpu_torch.scene.intersect import _first_block_key
    oc, dc = _bounce_rays(scene, n, sort=False)
    tm = torch.full((n,), 1e30, device=oc.device)
    perm = torch.argsort(_first_block_key(scene, oc, dc), stable=True)
    ok, dk = oc[perm].contiguous(), dc[perm].contiguous()
    rc = trace2.tri_intersect2(scene, oc, dc, tm, pops=4)
    rk = trace2.tri_intersect2(scene, ok, dk, tm, pops=4)
    diff = {k: int((rk[k] != rc[k][perm]).sum())
            for k in ("t", "tri", "inst", "valid")}
    times = _time_rounds({
        "caller": lambda: trace2.tri_intersect2(scene, oc, dc, tm, pops=4),
        "key": lambda: trace2.tri_intersect2(scene, ok, dk, tm, pops=4),
        "sort key": lambda: _first_block_key(scene, oc, dc)})
    for order, o_, d_ in (("caller", oc, dc), ("key", ok, dk)):
        c = trace2.tri_intersect2(scene, o_, d_, tm, pops=4,
                                  counters=True)["counters"].float().mean(0)
        ms, spread = times[order]
        print(f"[key order] {label}, {order} order: {ms:.3f} ms (median of "
              f"{ROUNDS} interleaved rounds, spread {spread:.1%}); per ray: "
              f"top refills {c[0]:.2f}, top slab tests {c[4]:.1f}, L1 visits "
              f"{c[1]:.2f}, leaf blocks {c[2]:.2f}", flush=True)
    ms, spread = times["sort key"]
    print(f"[key order] {label}: the sort key (_first_block_key) {ms:.3f} ms "
          f"(spread {spread:.1%}); sorted result un-permuted vs caller "
          f"order: lanes differing {diff}", flush=True)
    if any(diff.values()):
        raise RuntimeError(f"K1's result depends on the ray order on {label}")


def _bound_ms(mod, scene, o, d, t_max, amask=0, any_hit=False, **kw):
    """Least time for the work this run's rays need in this mode (an
    any-hit walk ends at its first occluder, so it is counted with
    any_hit=True, not as a closest walk), by tools/roofline.py's count
    from the kernel's counters.  Returns (bound ms, "operations" or
    "bytes", extra): K2's extra holds the bound of a flat scan of every
    block per front refill (refills x M slab tests in place of the counted
    ones)."""
    from pathtracing_tpu_torch.tools.roofline import traversal_bound
    kernel, _ = _fns(mod)
    res = kernel(scene, o, d, t_max, counters=True, amask=amask,
                 any_hit=any_hit, **kw)
    b = traversal_bound(scene, res, o.shape[0],
                        timed=kw.get("time") is not None)
    print(f"[bound] amask={amask} any_hit={any_hit} rays={o.shape[0]} "
          f"per-ray: {b['what']}; flops={b['flops']:.3e} bytes="
          f"{b['bytes']:.3e} ops_ms={b['ops_ms']:.4f} bytes_ms="
          f"{b['bytes_ms']:.4f}", flush=True)
    extra = ({"bound_ms_flat_scan": b["bound_ms_flat_scan"]}
             if "bound_ms_flat_scan" in b else {})
    return b["bound_ms"], b["bound_by"], extra


def _measure(mod, scene, o, d, t_max, label, modes, prune=True,
             brute_rays=0, **kw):
    """Hold the kernel's `modes` (a subset of closest / any_hit / amask1 /
    amask2) against the plain version on these rays (culled by box; with
    brute_rays also against the brute force on that many of them),
    compute each mode's own bound from its own counters, then time every
    mode in interleaved rounds (_time_rounds).  Returns {mode:
    dict(max_abs_err, ms, ms_spread, plain_ms, bound_ms, bound_by, ...)}
    with ms the median over the rounds; any_hit's max_abs_err is over the
    occlusion flags (its only output that is compared); K1's modes add
    ms_pops4 / ms_pops4_spread, the time at pops 4, K2's the flat-scan
    bound."""
    kernel, _ = _fns(mod)
    k1 = hasattr(mod, "tri_intersect2")
    out = {}
    fns = {}
    sub = {k: (v[:brute_rays] if v is not None else None)
           for k, v in kw.items() if k == "time"}
    kw_b = {**kw, **sub}

    def row(mode, err, plain_ms, **mkw):
        b_ms, b_by, extra = _bound_ms(mod, scene, o, d, t_max, **mkw, **kw)
        out[mode] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, **extra)
        fns[mode] = lambda: kernel(scene, o, d, t_max, **mkw, **kw)
        if k1:
            fns[mode + "_pops4"] = lambda: kernel(scene, o, d, t_max, pops=4,
                                                  **mkw, **kw)

    if "closest" in modes or "any_hit" in modes:
        if brute_rays:
            _compare(mod, scene, o[:brute_rays], d[:brute_rays],
                     t_max[:brute_rays], label, prune=False, **kw_b)
        cmp_c = _compare(mod, scene, o, d, t_max, label, prune=prune, **kw)
        for mode in ("closest", "any_hit"):
            if mode in modes:
                row(mode, *cmp_c[mode], any_hit=mode == "any_hit")
    if "amask1" in modes or "amask2" in modes:
        if brute_rays:
            _compare_amask(mod, scene, o[:brute_rays], d[:brute_rays],
                           t_max[:brute_rays], label, prune=False, **kw_b)
        cmp_a = _compare_amask(mod, scene, o, d, t_max, label, prune=prune,
                               **kw)
        for amask in (1, 2):
            err, plain_ms, share = cmp_a[amask]
            if not share > 0.0:
                raise RuntimeError(f"amask={amask} resolved no lane on "
                                   f"{label}")
            row(f"amask{amask}", err, plain_ms, amask=amask)
    for key, (med, spread) in _time_rounds(fns).items():
        mode = key[:-len("_pops4")] if key.endswith("_pops4") else key
        name = "ms_pops4" if key.endswith("_pops4") else "ms"
        out[mode][name] = med
        out[mode][name + "_spread"] = spread
    smem = mod.staged_bytes(scene)
    for mode, r in out.items():
        # the kernel's occupancy with these tables staged
        occ = mod.occupancy(mod.mode_name(
            mode == "any_hit", int(mode[-1]) if "amask" in mode else 0,
            "pk_blk_src" in scene, kw.get("time") is not None), smem=smem)
        p4 = (f" (pops 4: {r['ms_pops4']:.3f} ms, spread "
              f"{r['ms_pops4_spread']:.1%})" if k1 else "")
        flat = (f", flat-scan bound {r['bound_ms_flat_scan']:.4f} ms"
                if "bound_ms_flat_scan" in r else "")
        print(f"[kernel] {label} {mode}: {r['ms']:.3f} ms (median of "
              f"{ROUNDS} interleaved rounds, spread {r['ms_spread']:.1%})"
              f"{p4}, {occ} blocks of 128 per SM with {smem} B staged, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){flat}", flush=True)
    return out


def _launch_counts():
    """{"trace2[mode]" / "trace1[mode]": launches} of both traversal
    kernels, by mode (the modes partition the launches)."""
    from pathtracing_tpu_torch.accel import trace1, trace2
    out = {f"trace2[{k}]": v
           for k, v in trace2.tri_intersect2.launches_by_mode.items()}
    out.update({f"trace1[{k}]": v
                for k, v in trace1.tri_intersect1.launches_by_mode.items()})
    return out


def _schedule_counts():
    """{"trace2[capped|frontier|window2|window4|pair|pops<p>]": launches}:
    K1's launches by schedule (a capped launch with frontier outputs
    counts under both) and {"leaf[mode]": launches} of K4."""
    from pathtracing_tpu_torch.accel import trace2
    from pathtracing_tpu_torch.tools import bench_leaf
    out = {f"trace2[{k}]": v
           for k, v in trace2.tri_intersect2.launches_by_schedule.items()}
    out.update({f"leaf[{k}]": v
                for k, v in bench_leaf.leaf_run.launches_by_mode.items()})
    return out


def _reset_counts():
    from pathtracing_tpu_torch.accel import trace1, trace2
    from pathtracing_tpu_torch.tools import bench_leaf
    trace1.reset_launches()
    trace2.reset_launches()
    bench_leaf.reset_launches()


def _card_vs_cpu(render_image, scene, cam, meta, cfg, label, min_frac=0.99,
                 counts=None):
    """The same small render on the card (kernel, float32 GPU math) and
    on the CPU (plain traversal, the numerics the CPU tests hold to the
    JAX package); fails unless >99% of values agree to rtol=1e-4,
    atol=1e-5 (the JAX package's rule for two traversal paths)."""
    import torch
    _reset_counts()
    got = render_image(scene, cam, meta, cfg, device="cuda").cpu()
    if counts is not None:       # launches of the card render, by mode
        for k, v in {**_launch_counts(), **_schedule_counts()}.items():
            counts[k] = counts.get(k, 0) + v
    want = render_image(scene, cam, meta, cfg, device="cpu")
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
    frac = float(close.to(torch.float64).mean())
    diff = (got - want).abs()
    print(f"[card-vs-cpu] {label}: {frac * 100:.3f}% of {close.numel()} "
          f"values within rtol=1e-4 atol=1e-5; max |diff| "
          f"{float(diff.max()):.3e}, mean |diff| {float(diff.mean()):.3e}; "
          f"means {float(got.mean()):.6f} (card) {float(want.mean()):.6f} "
          f"(cpu)", flush=True)
    if not (torch.isfinite(got).all() and frac > min_frac):
        raise RuntimeError(f"card render of {label} disagrees with the CPU "
                           f"render")


def _shell_rays(rng, n, dev):
    """Rays from a shell of radius 120 toward the 120-wide soup box."""
    import numpy as np
    import torch
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 120.0
    d = rng.uniform(-60, 60, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _card_soup(rng, n_cards, dev, trace2):
    """Tables of the traversal module given (two-level for accel/trace2,
    single-level for accel/trace1), with micro-masks, of n_cards randomly oriented
    alpha-cutout cards (2 triangles each) carrying the faithful scene's
    leaf texture (MASK mode, cutoff 0.5)."""
    import numpy as np
    import torch
    from pathtracing_tpu_torch.scene.alphamask import build_tri_alpha_masks
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    from pathtracing_tpu_torch.scenes import _sm_textures
    c = rng.uniform(-60, 60, (n_cards, 3))
    s = rng.uniform(0.8, 3.0, (n_cards, 1))
    a = rng.normal(size=(n_cards, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = np.cross(a, rng.normal(size=(n_cards, 3)))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    q = np.stack([c - .5 * s * a - .5 * s * b, c + .5 * s * a - .5 * s * b,
                  c + .5 * s * a + .5 * s * b, c - .5 * s * a + .5 * s * b],
                 1).astype(np.float32)
    tri_v = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], 0)
    quv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    uvs = np.concatenate([np.broadcast_to(quv[[0, 1, 2]], (n_cards, 3, 2)),
                          np.broadcast_to(quv[[0, 2, 3]], (n_cards, 3, 2))], 0)
    sb = SceneBuilder()
    leaf_tid = _sm_textures(sb)[3]
    masks = build_tri_alpha_masks(uvs, np.zeros(len(uvs), np.int64),
                                  sb.textures, [2], [0.5],
                                  [[leaf_tid, -1, -1, -1, -1]])
    if hasattr(trace2, "build_tri_blocks2"):
        tabs, _ = trace2.build_tri_blocks2(tri_v, g=32, tri_mask=masks)
    else:
        tabs, _ = trace2.build_tri_blocks(tri_v, tri_mask=masks)
    return {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}


def _foliage_rays(scene, n, seed=5):
    """Rays through the foliage layer: origins up to 2.5 above the terrain
    all over the courtyard, directions uniform on the sphere, sorted by
    first entered block as the dispatch sorts them."""
    import numpy as np
    import torch
    from pathtracing_tpu_torch.scene.intersect import _first_block_key
    from pathtracing_tpu_torch.scenes import _sm_height
    rng = np.random.default_rng(seed)
    x = rng.uniform(3.0, 97.0, n).astype(np.float32)
    z = rng.uniform(3.0, 97.0, n).astype(np.float32)
    y = _sm_height(x, z) + rng.uniform(0.05, 2.5, n).astype(np.float32)
    o = np.stack([x, y, z], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dev = scene["pk_tri"].device
    o = torch.from_numpy(o).to(dev)
    d = torch.from_numpy(d).to(dev)
    perm = torch.argsort(_first_block_key(scene, o, d), stable=True)
    return o[perm].contiguous(), d[perm].contiguous()


def _occluded_card_vs_cpu(scene, cam, meta, n=8160, label="flattened"):
    """The shadow predicate (opaque any-hit pass + masked alpha restart
    chain) on the card against the port's CPU predicate, on rays through
    the small faithful scene's foliage toward the sun and the sky.  MASK
    mode is deterministic: every lane must be equal."""
    import numpy as np
    import torch
    from pathtracing_tpu_torch.scene.intersect import _occluded, occluded
    from pathtracing_tpu_torch.scenes import _sm_height
    rng = np.random.default_rng(23)
    x = rng.uniform(3.0, 97.0, n).astype(np.float32)
    z = rng.uniform(3.0, 97.0, n).astype(np.float32)
    y = _sm_height(x, z) + rng.uniform(0.02, 1.5, n).astype(np.float32)
    o = torch.from_numpy(np.stack([x, y, z], -1).astype(np.float32))
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1])
    d[: n // 2] = np.asarray([0.35, 1.0, 0.25], np.float32)   # to the sun
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d)
    t_max = torch.full((n,), 3e38)
    t_max[::3] = 6.0
    want = occluded(scene, meta, o, d, t_max, rand_key=7, device="cpu")
    got = occluded(scene, meta, o, d, t_max, rand_key=7, device="cuda").cpu()
    stats = {}
    dev = torch.device("cuda")
    _occluded({k: v.to(dev) for k, v in scene.items()}, meta, o.to(dev),
              d.to(dev), t_max.to(dev), rand_key=7, stats=stats)
    flips = int((got != want).sum())
    print(f"[occluded card-vs-cpu] {n} shadow rays through the foliage of "
          f"the small faithful scene ({label}): occluded {int(want.sum())} (cpu) "
          f"{int(got.sum())} (card), lane flips {flips}, chain restarts "
          f"{stats['restarts']}", flush=True)
    if flips or not 0 < int(want.sum()) < n:
        raise RuntimeError("the card's shadow predicate disagrees with the "
                           "CPU's")


def _frame(filmmod, scene, cam, meta, cfg, label, ppm):
    """Render one timed frame under cfg with both kernels' launch counts
    set to 0 just before it and read just after, through the bench's
    bench_frame (one timed repetition, no warm frame; sample_offset
    cfg.spp); print its numbers, check the image, write it.  Returns
    (launch counts by kernel and mode, dict(rays_per_sample, mean,
    samples_per_s, seconds))."""
    import torch
    from pathtracing_tpu_torch import bench
    from pathtracing_tpu_torch.accel import trace1, trace2
    w, h = cam["resolution"]
    stats = {}
    _reset_counts()
    t0 = time.perf_counter()
    _, film = bench.bench_frame(scene, cam, meta, cfg, reps=1, warm=False,
                                stats=stats)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    counts = _launch_counts()
    total = (trace2.tri_intersect2.launches
             + trace1.tri_intersect1.launches)
    img = filmmod.finalize(film)
    mean = float(img.mean())
    finite = bool(torch.isfinite(img).all())
    calls = stats.get("occluded_calls", 0)
    restarts = stats.get("chain_restarts", 0) / calls if calls else 0.0
    if total != sum(counts.values()):
        raise RuntimeError("per-mode launch counts do not add up")
    counts.update(_schedule_counts())
    used = {k: v for k, v in counts.items() if v}
    rps = stats["n_rays"] / (w * h)
    print(f"[render] {label}: {w}x{h} 1spp regen: timed "
          f"{frame_s:.2f}s camera_samples/s {w * h / frame_s:.1f} "
          f"rays/sample {rps:.3f} kernel launches {total} by kernel and mode "
          f"{used} occluded calls {calls} chain restarts/call {restarts:.3f} "
          f"bounce iterations {stats['iterations']}, lane bounces at depth "
          f">= 20: {stats['deep_bounces']}, of them with a closest hit nearer "
          f"than 1e-4 (re-hits): {stats['deep_rehits']}; "
          f"image mean {mean:.5f} finite {finite}", flush=True)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    filmmod.write_ppm(film, (w, h), out_dir / ppm)
    if not finite or not mean > 0.0:
        raise RuntimeError(f"bad image: mean={mean} finite={finite}")
    return counts, dict(rays_per_sample=rps, mean=mean, seconds=frame_s,
                        samples_per_s=w * h / frame_s,
                        iterations=stats["iterations"])


def _need(counts, keys, label):
    for k in keys:
        if counts.get(k, 0) <= 0:
            raise RuntimeError(f"{label} never launched {k}")


def _xf(rng):
    """A sheared, non-uniformly scaled, rotated, translated 4x4."""
    import numpy as np
    a = rng.uniform(0, np.pi)
    c, s = np.cos(a), np.sin(a)
    lin = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) \
        @ np.diag(rng.uniform(0.5, 2.0, 3))
    lin[0, 1] += 0.3
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = rng.uniform(-50, 50, 3)
    return m.astype(np.float32)


def _soup_tris(rng, n, spread=60.0, size=1.5):
    import numpy as np
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return np.stack([v0, v0 + rng.normal(0, size, (n, 3)),
                     v0 + rng.normal(0, size, (n, 3))], 1).astype(np.float32)


def _pyramid_scene(kind, device="cpu"):
    """Small scenes for the card-vs-CPU renders of run-time instances and
    motion: "inst" (three run-time instances of a pyramid + world
    triangles: single-level instanced tables), "moving_mesh" (a moving
    5,202-triangle mesh: single-level tables with velocities),
    "moving_inst" (a moving run-time instance + moving world triangles:
    two-level instanced tables with motion), "inst_big" (the instances
    over a 72,200-triangle mesh: more than 65,536 triangles, so two-level
    instanced tables), "moving_mesh_k1" (the moving mesh forced onto the
    two-level tables with TWOLEVEL_MIN = 0)."""
    import math
    import numpy as np
    from pathtracing_tpu_torch.scene import builder as builder_mod
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    pv = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                     [0, 1.2, 0]], np.float32)
    pf = np.asarray([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                     [0, 2, 1], [0, 3, 2]], np.int32)

    def tf(tx, ty, tz, s=1.0, ry=0.0):
        c, si = math.cos(ry), math.sin(ry)
        return np.asarray([[c * s, 0, si * s, tx], [0, s, 0, ty],
                           [-si * s, 0, c * s, tz], [0, 0, 0, 1]], np.float32)

    def grid(side, y0=0.0):
        x, z = np.meshgrid(np.linspace(-3, 3, side), np.linspace(-3, 3, side))
        y = 0.4 * np.sin(2 * x) * np.cos(2 * z) + y0
        v = np.stack([x, y, z], -1).reshape(-1, 3)
        i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1),
                           indexing="ij")
        a = (i * side + j).ravel()
        return v, np.concatenate([np.stack([a, a + 1, a + side], -1),
                                  np.stack([a + 1, a + side + 1, a + side],
                                           -1)])

    b = SceneBuilder()
    mat = b.add_diffuse((0.7, 0.5, 0.3))
    shutter = (0.0, 1.0)
    if kind in ("moving_mesh", "moving_mesh_k1"):
        b.add_mesh(*grid(52), material=mat, velocity=(1.5, 0.0, 0.0))
    else:
        mid = b.add_model(pv, pf, material=mat)
        moving = kind == "moving_inst"
        b.add_model_instance(mid, tf(-2, 0, 0, ry=0.5), runtime=True,
                             velocity=(2.0, 0.5, 0.0) if moving else (0, 0, 0))
        b.add_model_instance(mid, tf(2, 0, 1, s=1.5, ry=0.7), runtime=True)
        b.add_model_instance(mid, tf(0, 0, -2, s=0.7, ry=2.1), runtime=True)
        b.add_mesh(pv * 2.0 + np.asarray([0, 0, 5], np.float32), pf,
                   material=mat,
                   velocity=(0.0, 1.0, 0.0) if moving else (0, 0, 0))
        if kind == "inst_big":
            b.add_mesh(*grid(191, -0.6), material=mat)       # 72,200 tris
        b.add_quad([-6, -1.2, -6], [12, 0, 0], [0, 0, 12],
                   material=b.add_diffuse((0.5, 0.5, 0.5)))
        if not moving:
            shutter = (0.0, 0.0)
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera([0, 4, -7], [0, 0.5, 0], math.radians(40), (48, 48),
                 shutter=shutter)
    saved = builder_mod.TWOLEVEL_MIN
    if kind == "moving_mesh_k1":
        builder_mod.TWOLEVEL_MIN = 0
    try:
        return b.build(accel="pallas", device=device)
    finally:
        builder_mod.TWOLEVEL_MIN = saved


def _sections_frame(render, scene, cam, meta, cfg):
    """One more frame with a host timer and a device synchronize around
    the sections of a bounce iteration: where the frame's time goes, by
    module function.  Nested sections (marked ">") are part of the section
    above them.  The synchronizes cost a little and stop the host from
    running ahead of the device, so the frame is slower than the timed
    one; the shares are what this is for."""
    import torch
    from pathtracing_tpu_torch.accel import trace2 as T
    from pathtracing_tpu_torch.integrators import path as P
    from pathtracing_tpu_torch.scene import intersect as I
    acc = {}

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            key = name(*a, **k) if callable(name) else name
            cell = acc.setdefault(key, [0.0, 0])
            cell[0] += time.perf_counter() - t0
            cell[1] += 1
            return out
        return wrap

    def kernel_name(scene, o, d, t_max, any_hit, counters, amask, time=None,
                    **kw):
        return "  > K1 kernel " + T.mode_name(any_hit, amask,
                                               "pk_blk_src" in scene,
                                               time is not None)

    def dispatch_name(*a, any_hit=False, tri_tables="all", **k):
        return (f"  > _pallas_dispatch tri_tables={tri_tables} "
                f"any_hit={any_hit}")

    patches = [
        (P, "_intersect", "closest pass: _intersect (sort key, K1 closest "
         "+ amask1, analytic prims)"),
        (P, "make_interaction", "make_interaction (tangents, normal map)"),
        (P, "resolve_material", "resolve_material (base texture)"),
        (P, "bsdf_sample", "bsdf_sample"),
        (P, "bsdf_eval_pdf", "bsdf_eval_pdf (NEE + MIS)"),
        (P, "_occluded", "shadow predicate: _occluded (key, K1 any-hit, "
         "alpha restart chain)"),
        (I, "_pallas_dispatch", dispatch_name),
        (I, "_first_block_key", "  > _first_block_key (dispatch sort key)"),
        (I, "_chain_interaction", "  > _chain_interaction (restart chain)"),
        (I, "texture_alpha", "  > texture_alpha (restart chain's exact "
         "test)"),
        (I, "texture_eval", "  > texture_eval in make_interaction (normal "
         "map)"),
        (P, "texture_eval", "  > texture_eval in resolve_material"),
        (P, "texture_alpha", "  > texture_alpha in the bounce (see-through "
         "test)"),
        (T, "_launch_kernel", kernel_name),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, name in patches:
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, cam, meta, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    print(f"[sections] instrumented frame {wall:.2f}s", flush=True)
    top = sum(v[0] for k, v in acc.items() if not k.startswith("  >"))
    # the bounce loop's sections first, then the nested ones
    for key, (sec, calls) in sorted(acc.items(),
                                    key=lambda kv: kv[0].startswith("  >")):
        print(f"[sections] {sec:8.2f}s {100.0 * sec / wall:5.1f}% "
              f"{calls:6d} calls  {key}", flush=True)
    print(f"[sections] {wall - top:8.2f}s {100.0 * (wall - top) / wall:5.1f}%"
          f"               the rest of the bounce loop (lights, RNG, "
          f"throughput, regeneration, film)", flush=True)


def _profile_frame(render, scene, cam, meta, cfg):
    """One more frame under torch.profiler: wall time, summed device
    kernel time (busy share) and the device kernels that take most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, cam, meta, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in events)
    n_kernels = len(events)
    print(f"[profile] frame wall {wall:.2f}s (profiled), device kernels "
          f"{n_kernels}, device busy {busy_us / 1e6:.2f}s "
          f"({100.0 * busy_us / 1e6 / wall:.1f}% of wall)", flush=True)
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3:9.1f} ms  {c:7d} launches  {name[:90]}",
              flush=True)


def _diff_counts(got, ref, closest, amask=0, frontier=False):
    """Lanes where two K1 results differ: valid always; t, tri and inst
    for a closest walk; solid under amask 2; e_next / b_next with a
    frontier."""
    keys = ["valid"] + (["t", "tri", "inst"] if closest else [])
    if amask == 2:
        keys.append("solid")
    if frontier:
        keys += ["e_next", "b_next"]
    return {k: int((got[k] != ref[k]).sum()) for k in keys}


def _compare_schedules(scene, o, d, t_max, label, amasks=(0,), **kw):
    """K1's schedules (window 2 / 4 with pops = 2 * window, pair, pops 1
    and 4) against its window=1, pops=1 walk: a schedule changes the order
    of the work, never the result, so no lane may differ (closest: t, tri,
    inst, valid; any-hit: valid; amask 2: also solid)."""
    from pathtracing_tpu_torch.accel import trace2
    for amask in amasks:
        for any_hit in ((False, True) if amask == 0 else (False,)):
            base = trace2.tri_intersect2(scene, o, d, t_max, any_hit=any_hit,
                                         amask=amask, **kw)
            for sched in SCHEDULES:
                got = trace2.tri_intersect2(scene, o, d, t_max,
                                            any_hit=any_hit, amask=amask,
                                            **sched, **kw)
                diff = _diff_counts(got, base, not any_hit, amask)
                print(f"[schedule] {label} amask={amask} any_hit={any_hit} "
                      f"{sched} vs window=1 pops=1: hits "
                      f"{int(base['valid'].sum())}, lanes differing {diff}",
                      flush=True)
                if any(diff.values()):
                    raise RuntimeError(f"K1 schedule {sched} changed the "
                                       f"result on {label}")


def _compare_caps(scene, o, d, t_max, label, prune=True, **kw):
    """K1's capped walk with frontier outputs (caps 1, 2, 16) against the
    plain capped walk: t, tri, inst, valid (closest; valid only for
    any-hit, whose occluder is whichever the walk found first), e_next and
    b_next must agree on every lane."""
    from pathtracing_tpu_torch.accel import trace2
    for any_hit in (False, True):
        for cap in CAPS:
            got = trace2.tri_intersect2(scene, o, d, t_max, any_hit=any_hit,
                                        max_visits=cap, frontier=True, **kw)
            ref = trace2.tri_intersect2_plain(scene, o, d, t_max,
                                              any_hit=any_hit, prune=prune,
                                              max_visits=cap, frontier=True,
                                              **kw)
            diff = _diff_counts(got, ref, not any_hit, frontier=True)
            print(f"[cap] {label} any_hit={any_hit} max_visits={cap} vs "
                  f"{'culled' if prune else 'brute'} plain capped walk: "
                  f"hits {int(ref['valid'].sum())} unresolved "
                  f"{int((ref['e_next'] < 3e38).sum())}, lanes differing "
                  f"{diff}", flush=True)
            if any(diff.values()):
                raise RuntimeError(f"K1 max_visits={cap} disagrees with the "
                                   f"plain capped walk on {label}")


def _measure_schedules(scene, o, d, t_max, label):
    """Time, bound and plain-version time of K1's new modes on these rays
    (closest hit): the capped walk (cap 16) without and with its frontier
    outputs, window 2 / 4 and pair at the main path's pops=4, and pops 4
    alone.  The plain version of a schedule is the uncapped plain walk
    (schedules do not change the function); the capped rows' is the plain
    capped walk.  Returns rows keyed trace2[capped] ... trace2[pops4]."""
    import torch
    from pathtracing_tpu_torch.accel import trace2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace2.tri_intersect2_plain(scene, o, d, t_max)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows = {}
    smem = trace2.staged_bytes(scene)
    scheds = (("capped", dict(max_visits=16)),
              ("frontier", dict(max_visits=16, frontier=True)),
              ("window2", dict(window=2, pops=4)),
              ("window4", dict(window=4, pops=4)),
              ("pair", dict(pair=True, pops=4)),
              ("pops4", dict(pops=4)))
    times = _time_rounds({name: (lambda kw=kw: trace2.tri_intersect2(
        scene, o, d, t_max, **kw)) for name, kw in scheds})
    for name, kw in scheds:
        ms, spread = times[name]
        b_ms, b_by, _ = _bound_ms(trace2, scene, o, d, t_max, **kw)
        p_ms = plain_ms
        if "max_visits" in kw:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trace2.tri_intersect2_plain(scene, o, d, t_max, **kw)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
        rows[f"trace2[{name}]"] = dict(max_abs_err=0.0, ms=ms,
                                       ms_spread=spread, plain_ms=p_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       schedule=str(kw))
        occ = (f", window kernel {trace2.occupancy('closest', window=True,
                                                       smem=smem)} blocks "
               f"of 128 per SM" if "window" in kw else "")
        print(f"[kernel] {label} {name} {kw}: {ms:.3f} ms (median of "
              f"{ROUNDS} interleaved rounds, spread {spread:.1%}){occ}, "
              f"plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
    return rows


def _measure_windows(scene, o, d, t_max, label):
    """K1's window walk on alpha tables, as path C runs it on its amask 1
    / 2 passes: windows 2 and 4 at the main path's pops 4 against the
    plain amask walk on every lane (valid, tri, solid equal, t to its
    max abs error), then timed in interleaved rounds beside the window=1
    walk at pops 4, each with its bound from its own counters and the
    window kernel's blocks per SM with these tables staged.  Returns rows
    keyed trace2[window<w>_amask<a>]."""
    import torch
    from pathtracing_tpu_torch.accel import trace2
    fns = {(a, w): (lambda a=a, w=w: trace2.tri_intersect2(
        scene, o, d, t_max, amask=a, window=w if w > 1 else None, pops=4))
        for a in (1, 2) for w in (1, 2, 4)}
    smem = trace2.staged_bytes(scene)
    errs, plain = {}, {}
    for a in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = trace2.tri_intersect2_plain(scene, o, d, t_max, amask=a)
        torch.cuda.synchronize()
        plain[a] = (time.perf_counter() - t0) * 1e3
        for w in (2, 4):
            got = fns[(a, w)]()
            diff = _diff_counts(got, ref, True, a)
            both = got["valid"] & ref["valid"]
            errs[(a, w)] = float((got["t"][both] - ref["t"][both]).abs()
                                 .max()) if bool(both.any()) else 0.0
            print(f"[window] {label} amask={a} window={w} pops=4 vs the "
                  f"plain walk: hits {int(ref['valid'].sum())}, lanes "
                  f"differing {diff}, t max abs err {errs[(a, w)]:.3e}",
                  flush=True)
            if diff["valid"] or diff["tri"] or diff.get("solid", 0):
                raise RuntimeError(f"K1 window {w} amask {a} disagrees with "
                                   f"the plain walk on {label}")
    times = _time_rounds(fns)
    rows = {}
    for a in (1, 2):
        occ = trace2.occupancy(f"amask{a}", window=True, smem=smem)
        w1, w1_spread = times[(a, 1)]
        for w in (2, 4):
            ms, spread = times[(a, w)]
            b_ms, b_by, _ = _bound_ms(trace2, scene, o, d, t_max, amask=a,
                                      window=w, pops=4)
            rows[f"trace2[window{w}_amask{a}]"] = dict(
                max_abs_err=errs[(a, w)], ms=ms, ms_spread=spread,
                plain_ms=plain[a], bound_ms=b_ms, bound_by=b_by,
                schedule=str(dict(window=w, pops=4, amask=a)),
                ms_window1=w1, ms_window1_spread=w1_spread)
            print(f"[kernel] {label} window{w} amask{a} (pops 4): {ms:.3f} ms "
                  f"(median of {ROUNDS} interleaved rounds, spread "
                  f"{spread:.1%}; the window=1 walk {w1:.3f} ms, spread "
                  f"{w1_spread:.1%}), {occ} blocks of 128 per SM with {smem} "
                  f"B staged, plain {plain[a]:.1f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
    return rows


def _multipass_check(scene, o, d, t_max, label):
    """The multipass driver (scene/intersect.py::_multipass2, caps
    MULTIPASS then an uncapped pass) against one uncapped K1 pass: valid
    and t equal on every ray; tri may differ only between two triangles
    at the same t (the driver keeps a pass's hit only when strictly
    closer).  Closest and any-hit (valid only)."""
    import torch
    from pathtracing_tpu_torch.accel import trace2
    from pathtracing_tpu_torch.scene.intersect import _multipass2
    for any_hit in (False, True):
        one = trace2.tri_intersect2(scene, o, d, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp = _multipass2(scene, o, d, t_max, any_hit, None, MULTIPASS)
        torch.cuda.synchronize()
        mp_ms = (time.perf_counter() - t0) * 1e3
        one_ms = _sync_time(lambda: trace2.tri_intersect2(
            scene, o, d, t_max, any_hit=any_hit), reps=5)
        v_diff = int((mp["valid"] != one["valid"]).sum())
        t_diff = 0 if any_hit else int((mp["t"] != one["t"]).sum())
        tri_diff = 0 if any_hit else int((mp["tri"] != one["tri"]).sum())
        print(f"[multipass] {label} any_hit={any_hit} visits={MULTIPASS}: "
              f"{mp_ms:.1f} ms (host clock, 4 passes + re-sorts) vs one pass "
              f"{one_ms:.3f} ms; hits {int(one['valid'].sum())}, valid "
              f"differing {v_diff}, t differing {t_diff}, tri differing "
              f"{tri_diff} (only where two triangles tie in t)", flush=True)
        if v_diff or t_diff:
            raise RuntimeError(f"the multipass driver disagrees with one "
                               f"pass on {label}")


def _leaf_phase():
    """K4: hold every mode against its plain version at a small n_iter (the
    vpu modes bit for bit in the build of every lane count, the
    tensor-core modes within the tolerances below), then run the JAX
    tool's defaults through the port's entry point (bench_leaf.bench:
    ROUNDS interleaved rounds, the scalar modes in every lane count's
    build, the package's first; the other builds' launches are not
    counted) with the launch
    counts set to 0 just before and read just after, and time the plain
    versions and the library product (ROUNDS interleaved rounds).  Each
    mode's bound is printed for the card and for the one SM its single
    block runs on (x 132).  Returns (rows keyed leaf[mode], launches by
    mode)."""
    import torch
    from pathtracing_tpu_torch.tools import bench_leaf as bl
    from pathtracing_tpu_torch.tools.roofline import (FP32_PEAK, HBM_RATE,
                                                      MT_FLOPS)
    k2 = LEAF_K2
    tabs = bl.kernel_tables(bl.make_inputs(k2), "cuda")
    # vpu*: the same float32 operations in the same order (no FMA
    # contraction), so equal; mxu_hi: 3xTF32 against an f32 product, a few
    # f32 ulps of det/t*det; mxu_3x / mxu_1x: bf16 operands, the tensor
    # cores sum the exact products in another order than the plain loop
    tol = dict(mxu_hi=1e-4, mxu_3x=1e-3, mxu_1x=1e-3)
    lanes = (bl.DEFAULT_LANES,) + tuple(w for w in bl.LANES
                                        if w != bl.DEFAULT_LANES)
    libs = {w: bl.build(lanes=w) if w != bl.DEFAULT_LANES else None
            for w in lanes}
    abs_err = {}
    for mode in bl.MODES:
        ref = bl.leaf_plain(mode, tabs, k2, 16)
        for w in (lanes if not mode.startswith("mxu") else lanes[:1]):
            got = bl.leaf_run(mode, tabs, k2, 16, libs[w])
            err = bl.max_rel_err(got, ref)
            if w == bl.DEFAULT_LANES:
                abs_err[mode] = float((got - ref).abs().max())
            print(f"[leaf] {mode} n_iter=16 vs plain"
                  f"{'' if mode.startswith('mxu') else f' W={w}'}: max rel "
                  f"err {err:.3e} (allowed {tol.get(mode, 0.0):.0e}); hits "
                  f"{int((ref < 1e29).sum())}/128", flush=True)
            if not err <= tol.get(mode, 0.0):
                raise RuntimeError(f"leaf mode {mode} disagrees with its "
                                   f"plain version")
    torch.cuda.synchronize()
    _reset_counts()
    res = bl.bench(k2, LEAF_ITERS, ROUNDS, lanes,
                   printer=lambda x: print(f"[leaf] {x}", flush=True))
    torch.cuda.synchronize()
    counts = _schedule_counts()
    # the product of the tensor-core modes as one torch.matmul call each
    rays = tabs["rays"]
    o, dd = rays[0:3].T, rays[3:6].T
    a = torch.stack([dd[:, 0], dd[:, 1], dd[:, 2], o[:, 0], o[:, 1], o[:, 2],
                     o[:, 1] * dd[:, 2] - o[:, 2] * dd[:, 1],
                     o[:, 2] * dd[:, 0] - o[:, 0] * dd[:, 2],
                     o[:, 0] * dd[:, 1] - o[:, 1] * dd[:, 0],
                     torch.ones_like(o[:, 0])] + [torch.zeros_like(o[:, 0])] * 6,
                    1).contiguous()
    b = tabs["trib"]
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    al = (a - ah.float()).to(torch.bfloat16)
    bl_ = (b - bh.float()).to(torch.bfloat16)
    lib = {"mxu_hi": lambda: torch.matmul(a, b),
           "mxu_3x": lambda: (torch.matmul(ah, bh).float()
                              + torch.matmul(ah, bl_).float()
                              + torch.matmul(al, bh).float()),
           "mxu_1x": lambda: torch.matmul(ah, bh)}
    torch.backends.cuda.matmul.allow_tf32 = False

    def calls(fn, n=LIB_CALLS):
        def run():
            for _ in range(n):
                fn()
        return run
    # ms per call: median, spread (each sample LIB_CALLS x 20 calls)
    lib_t = {k: (m / LIB_CALLS, sp) for k, (m, sp) in _time_rounds(
        {k: calls(fn) for k, fn in lib.items()}).items()}
    rows = {}
    for mode in bl.MODES:
        r = res[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bl.leaf_plain(mode, tabs, k2, LEAF_ITERS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        pairs = 128 * k2 * (LEAF_ITERS // 16 * 16 if mode == "vpu_while"
                            else LEAF_ITERS)
        if mode.startswith("mxu"):
            passes = 1 if mode == "mxu_1x" else 3
            ops = passes * 2 * 128 * 16 * 4 * k2 * LEAF_ITERS
            peak = TF32_PEAK if mode == "mxu_hi" else BF16_PEAK
            bound = max(ops / peak, pairs * MXU_POST_FLOPS / FP32_PEAK) * 1e3
            lib_ms = lib_t[mode][0] * LEAF_ITERS
            lib_txt = (f"library: {LEAF_ITERS} x one torch.matmul of the "
                       f"[128,16] x [16,{4 * k2}] product at this precision "
                       f"({lib_t[mode][0] * 1e3:.2f} us each, median of "
                       f"{ROUNDS} interleaved rounds, spread "
                       f"{lib_t[mode][1]:.1%})")
        else:
            ops_ms = pairs * MT_FLOPS / FP32_PEAK * 1e3
            streamed = (LEAF_ITERS if mode in ("vpu_dma", "vpu_while")
                        else 1) * k2 * 48
            bound = max(ops_ms, (streamed + 128 * 32) / HBM_RATE * 1e3)
            lib_ms = None
            lib_txt = "library: none (no PyTorch call runs a ray/triangle test)"
        rows[f"leaf[{mode}]"] = dict(
            max_abs_err=abs_err[mode], ms=r["ms"], ms_spread=r["spread"],
            plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
            bound_one_sm_ms=bound * N_SM, library_ms=lib_ms,
            us_per_child=r["us_per_child"], library=lib_txt,
            max_rel_err_vs_vpu=r["err_vs_vpu"],
            ms_by_lanes={str(w): m for w, (m, _) in r["by_lanes"].items()})
        faster = (f"; {lib_ms / r['ms']:.2f}x faster than the library"
                  if lib_ms else "")
        print(f"[kernel] leaf {mode}: {r['ms']:.3f} ms per run of "
              f"{LEAF_ITERS} child tests (median of {ROUNDS} interleaved "
              f"rounds, spread {r['spread']:.1%}; {r['us_per_child']:.3f} "
              f"us/child), plain {plain_ms:.1f} ms, bound {bound:.4f} ms on "
              f"the card, {bound * N_SM:.3f} ms on the one SM it runs on "
              f"(operations), {lib_txt}{faster}", flush=True)
    return rows, counts


def _medium_mesh_scene(two_level, window=None, device="cpu"):
    """Small volpath scene whose medium is bounded by a triangle mesh: a
    5,000-triangle sphere mesh without a material (medium=fog inside)
    over a diffuse floor, a diffuse sphere, an area light and a sky.
    two_level: build its tables with TWOLEVEL_MIN = 0 (K1), else the
    default rule (K2)."""
    from pathtracing_tpu_torch import scenes
    from pathtracing_tpu_torch.scene import builder as builder_mod
    saved = builder_mod.TWOLEVEL_MIN
    if two_level:
        builder_mod.TWOLEVEL_MIN = 0
    try:
        return scenes.medium_mesh(resolution=(48, 48), device=device)
    finally:
        builder_mod.TWOLEVEL_MIN = saved


def _grad_probe_scene(device):
    """tests/test_regen_diff.py's scene (a floor, a rough diffuse and a
    metal sphere, a one-sided area light, a sky) with its floor textured
    (an 8x8 texture drawn from a seed), so texel gradients are held too."""
    import math
    import numpy as np
    from pathtracing_tpu_torch import SceneBuilder
    b = SceneBuilder()
    tid = b.textures.add_image(np.random.default_rng(7).uniform(
        0.2, 0.9, (8, 8, 3)).astype(np.float32))
    b.add_quad([-8, 0, -8], [16, 0, 0], [0, 0, 16],
               material=b.add_diffuse((0.65, 0.6, 0.55), base_tex=tid))
    b.add_sphere([0, 1, 0], 1.0,
                 material=b.add_diffuse((0.5, 0.3, 0.25), roughness=0.6))
    b.add_sphere([2.2, 0.8, -1.0], 0.8,
                 material=b.add_conductor((0.9, 0.7, 0.4)))
    b.add_quad([-1, 4, -1], [2, 0, 0], [0, 0, 2],
               emission=(14.0, 12.0, 10.0), one_sided=True)
    b.add_uniform_inf_light((0.3, 0.4, 0.55))
    b.set_camera([0, 2.5, -7], [0, 1, 0], math.radians(45), GRAD_PROBE_RES)
    return b.build(device=device)


_GRAD_NAMES = ("mat_base", "tex_texels")


def _probe_cfg(seed):
    from pathtracing_tpu_torch import RenderConfig, SamplerConfig
    return RenderConfig(spp=1, max_depth=5, integrator="path",
                        sampler=SamplerConfig(x_samples=4, y_samples=2,
                                              seed=seed))


def _probe_regen_grads(scene, cam, meta, cfg, device):
    """The probe's gradients through trace_regen_diff (two waves, half as
    many lanes as pixels), one CPU tensor per name of _GRAD_NAMES."""
    import torch
    from pathtracing_tpu_torch.integrators.regen_diff import trace_regen_diff
    w, h = cam["resolution"]
    pix = torch.arange(w * h, device=device)
    leaves = {k: scene[k].clone().requires_grad_() for k in _GRAD_NAMES}
    trace_regen_diff(dict(scene, **leaves), cam, meta, cfg, pix, 2, 0,
                     lanes=w * h // 2, device=device).sum().backward()
    return [leaves[k].grad.cpu() for k in _GRAD_NAMES]


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


def _grad_parity(dev):
    """[grad] a: the probe scene's mat_base and texel gradients on the card
    against the port's CPU gradients (which the CPU tests hold to the JAX
    package), through the regenerating form and the scan form (one trace
    per wave).  The gate must also tell a fault: the card's regenerating
    gradients of other samples (sampler seed 10) must read above
    GRAD_REL_TOL against the CPU's of seed 9."""
    import dataclasses
    import torch
    from pathtracing_tpu_torch.integrators.path import trace
    from pathtracing_tpu_torch.sensor.camera import camera_lanes
    cfg = _probe_cfg(9)
    scan_cfg = dataclasses.replace(cfg, differentiable=True)
    names = _GRAD_NAMES
    got = {}
    for device in ("cpu", dev):
        t0 = time.perf_counter()
        scene, cam, meta = _grad_probe_scene(device)
        w, h = cam["resolution"]
        pix = torch.arange(w * h, device=device)
        regen = _probe_regen_grads(scene, cam, meta, cfg, device)
        leaves = {k: scene[k].clone().requires_grad_() for k in names}
        for wave in range(2):
            px, py = pix % w, pix // w
            sidx = torch.full_like(pix, wave)
            o, d, tm, _ = camera_lanes(cam, cfg.sampler, px, py, sidx)
            trace(dict(scene, **leaves), cam, meta, scan_cfg, o, d, tm, px,
                  py, sidx, device=device).sum().backward()
        scan = [leaves[k].grad.cpu() for k in names]
        got[str(device)] = dict(regen=regen, scan=scan)
        print(f"[grad] probe {w}x{h} depth {cfg.max_depth} on {device}: "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    for form in ("regen", "scan"):
        for name, g_card, g_cpu in zip(names, got[str(dev)][form],
                                       got["cpu"][form]):
            scale = float(g_cpu.abs().max())
            err = _rel_err(g_card, g_cpu)
            ok = bool(torch.isfinite(g_card).all()) and scale > 0 \
                and err <= GRAD_REL_TOL
            print(f"[grad] card vs cpu {form} d(sum)/d({name}): relative "
                  f"max-abs error {err:.3e} (tolerance {GRAD_REL_TOL:g}), "
                  f"max |grad| {scale:.4g}: {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"card {form} gradients of {name} "
                                   f"disagree with the CPU's")
    scene, cam, meta = _grad_probe_scene(dev)
    other = _probe_regen_grads(scene, cam, meta, _probe_cfg(10), dev)
    for name, g_other, g_cpu in zip(names, other, got["cpu"]["regen"]):
        err = _rel_err(g_other, g_cpu)
        print(f"[grad] a fault's reading: card regen d(sum)/d({name}) of "
              f"sampler seed 10 against the CPU's of seed 9: relative "
              f"max-abs error {err:.3e} (must exceed {GRAD_REL_TOL:g}): "
              f"{'ok' if err > GRAD_REL_TOL else 'FAIL'}", flush=True)
        if not err > GRAD_REL_TOL:
            raise RuntimeError(f"the [grad] gate does not tell other "
                               f"samples' gradients of {name} from a match")


def _same_outputs(label, outs, ref_outs):
    """The recording forward's radiance against trace_regen's, group by
    group: bit-equal or a failure."""
    import torch
    same = [bool(torch.equal(a, b)) for a, b in zip(outs, ref_outs)]
    diff = max(float((a - b).abs().max()) for a, b in zip(outs, ref_outs))
    print(f"[grad] recording forward vs trace_regen, {label}: "
          f"{sum(same)} of {len(same)} queue groups bit-equal (max |diff| "
          f"{diff:.3e})", flush=True)
    if not all(same):
        raise RuntimeError(f"the recording forward ({label}) is not "
                           f"trace_regen's")


def _grad_frames(scene, cam, meta, sections):
    """[grad] b: fwd+bwd of the faithful frame with respect to mat_base:
    the regenerating form at depth 8 over the whole frame and at
    DEPTH_FAITHFUL over its first queue group (the whole frame there
    takes longer than the script's limit leaves), the scan form at
    GRAD_SCAN_DEPTH with compact_after=GRAD_COMPACT; one timed run each,
    no warm run (eager PyTorch compiles nothing, and the kernels are
    built and warm from the earlier phases), no timer inside a backward
    pass; the depth-8 runs through the bench's functions.  The fwd+bwd /
    forward ratios divide by the plain regenerating forward over the same
    queue groups (timed here).  The recording forward's radiance is held
    to trace_regen's: every group at depth 8, the first group at
    DEPTH_FAITHFUL.  sections: run both regenerating forms over the whole
    frame once more with a synchronized timer around each section of the
    backward pass, and print its split into shade replay and
    autograd.grad."""
    from pathtracing_tpu_torch import bench
    from pathtracing_tpu_torch.tools import bench_grad as bg
    w, h = cam["resolution"]
    plain = bg.regen_forward(scene, cam, meta, 8)
    print(f"[grad] plain regenerating forward d8 (trace_regen over the same "
          f"queue groups): {plain['seconds']:.2f}s, K1/K2 launches by group "
          f"{plain['launches']}", flush=True)
    first = bg.regen_forward(scene, cam, meta, DEPTH_FAITHFUL, n_groups=1)
    print(f"[grad] plain regenerating forward d{DEPTH_FAITHFUL}, the first "
          f"queue group: {first['seconds']:.2f}s, K1/K2 launches "
          f"{first['launches']}", flush=True)
    deep_label = f"regen d{DEPTH_FAITHFUL} (the first queue group)"
    runs = [("regen d8", plain,
             lambda: bench.bench_mesh_fwd_bwd_regen(scene, cam, meta, 8,
                                                    reps=1, warm=False)),
            (deep_label, first,
             lambda: bg.fwd_bwd_regen(scene, cam, meta, DEPTH_FAITHFUL,
                                      n_groups=1)),
            (f"scan d{GRAD_SCAN_DEPTH} compact_after={GRAD_COMPACT}", plain,
             lambda: bench.bench_mesh_fwd_bwd_frame(
                 scene, cam, meta, GRAD_SCAN_DEPTH, GRAD_COMPACT,
                 warm=False))]
    out = {}
    for label, fwd, fn in runs:
        _reset_counts()
        r = fn()
        modes = {k: v for k, v in _launch_counts().items() if v}
        per = r.get("bytes_per_lane_iter", r.get("bytes_per_lane_bounce"))
        unit = "iteration" if "bytes_per_lane_iter" in r else \
            "bounce (memory held by a tile's forward)"
        extra = {k: r[k] for k in ("iterations", "rays_per_sample", "groups",
                                   "launches_fwd_by_group", "tiles",
                                   "tile_rows", "fwd_s", "bwd_s",
                                   "backward_replay_s", "backward_grad_s")
                 if r.get(k) is not None}
        print(f"[grad] faithful {w}x{h} fwd+bwd {label}: timed "
              f"{r['seconds']:.2f}s, camera samples/s "
              f"{r['samples_per_s']:.1f}, fwd+bwd / plain forward "
              f"{r['seconds'] / fwd['seconds']:.3f}, "
              f"peak memory {(r['peak_bytes'] or 0) / 2**30:.3f} GiB, "
              f"{per or 0:.1f} B per lane per {unit}, K1/K2 launches forward "
              f"{r['launches_fwd']} backward {r['launches_bwd']} (by kernel "
              f"and mode {modes}), gradients finite {r['finite']}, {extra}",
              flush=True)
        if not r["finite"]:
            raise RuntimeError(f"{label}: a gradient is not finite")
        if any(r["launches_bwd"].values()):
            raise RuntimeError(f"{label}: the backward pass launched a "
                               f"traversal kernel")
        _need(modes, [f"trace2[{m}]" for m in ("closest", "any_hit", "amask1",
                                               "amask2")], label)
        if not float(r["grad"].abs().sum()) > 0:
            raise RuntimeError(f"{label}: the gradient is zero")
        out[label] = r
    _same_outputs("d8, the whole frame", out["regen d8"]["outs"],
                  plain["outs"])
    deep = out[deep_label]
    _same_outputs(f"d{DEPTH_FAITHFUL}, the first group", deep["outs"],
                  first["outs"])
    print(f"[grad] recording forward d{DEPTH_FAITHFUL}, the first group: "
          f"{deep['launches_fwd_by_group'][0]} K1/K2 launches against "
          f"trace_regen's {first['launches'][0]}", flush=True)
    if not sections:
        return out
    for depth in (8, DEPTH_FAITHFUL):
        r = bg.fwd_bwd_regen(scene, cam, meta, depth, sections=True)
        print(f"[sections] fwd+bwd regen d{depth} with a synchronized timer "
              f"per backward section: {r['seconds']:.2f}s (forward "
              f"{r['fwd_s']:.2f}s, backward {r['bwd_s']:.2f}s: shade replay "
              f"{r['backward_replay_s']:.2f}s, autograd.grad "
              f"{r['backward_grad_s']:.2f}s), gradients finite "
              f"{r['finite']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# [bvh]: the accel="bvh" backend; [bench]: the bench's own rows
# ---------------------------------------------------------------------------

def _bvh_phase(scene, meta, o, d, k1_ms):
    """[bvh] the per-ray-stack wide-BVH walk (accel/build.build_bvh,
    accel/traverse.bvh_intersect; plain PyTorch, no kernel of its own) on
    the legacy scene's triangles: build seconds, then closest and any-hit
    on the bounce rays o, d against K1 on the same rays and tables: valid
    equal, t to rtol=1e-5, and the triangle equal except on lanes where
    each reports a triangle the other also hits at its t (a shared edge
    or vertex: K1 ties to the least slot, the walk to the first found);
    each dispatch's seconds and loop iterations (one host sync each)
    beside K1's closest time k1_ms."""
    import torch
    from pathtracing_tpu_torch.accel import trace2
    from pathtracing_tpu_torch.accel.build import build_bvh
    from pathtracing_tpu_torch.accel.traverse import bvh_intersect
    dev = o.device
    tri_v = scene["tri_v"][:meta.n_tri]
    t0 = time.perf_counter()
    arrays, bm = build_bvh(dict(tri_v=tri_v.cpu().numpy()))
    bvh = {k: scene[k] for k in ("tri_v", "sph_c", "sph_r", "quad_q",
                                 "quad_u", "quad_v", "quad_n", "quad_d",
                                 "quad_w")}
    bvh.update({k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[bvh] build_bvh over {meta.n_tri:,} triangles (native SAH "
          f"build, wide collapse, block cut) + upload: {build_s:.2f}s; "
          f"{bm.n_nodes:,} wide nodes, depth {bm.max_depth}, block_k "
          f"{bm.block_k}", flush=True)
    t_max = torch.full((o.shape[0],), 1e30, device=dev)
    out = dict(build_s=build_s)
    for any_hit in (False, True):
        mode = "any-hit" if any_hit else "closest"
        runs = []
        for _ in range(2):          # the second call is the timed one
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = bvh_intersect(bvh, o, d, t_max, any_hit=any_hit,
                                shapes=(True, False, False), stats=st)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, st["iterations"]))
        ref = trace2.tri_intersect2(scene, o, d, t_max, any_hit=any_hit)
        v = ref["valid"]
        flips = int((got["valid"] != v).sum())
        msg = (f"[bvh] {mode} on {o.shape[0]} bounce rays: "
               f"{runs[-1][0] * 1e3:.1f} ms, {runs[-1][1]} iterations "
               f"(first call {runs[0][0] * 1e3:.1f} ms); K1 closest "
               f"{k1_ms:.3f} ms; valid lanes {int(v.sum())}, flips {flips}")
        if flips:
            raise RuntimeError(msg)
        if not any_hit:
            tk, tb = ref["t"][v], got["t"][v]
            t_err = float(((tb - tk).abs() / tk.abs()).max())
            other = v & (got["idx"] != ref["tri"])
            ok = True
            if other.any():
                tv = bvh["tri_v"]
                t_alt = _ray_tri_t(o[other], d[other], tv[got["idx"][other]])
                t_ref = _ray_tri_t(o[other], d[other], tv[ref["tri"][other]])
                ok = bool(torch.allclose(t_alt, ref["t"][other], rtol=1e-5)
                          and torch.allclose(t_ref, got["t"][other],
                                             rtol=1e-5))
            msg += (f", max rel t error {t_err:.2e}, other triangle on "
                    f"{int(other.sum())} lanes (each hit by both walks at "
                    f"the same t: {ok})")
            if not (t_err <= 1e-5 and ok):
                raise RuntimeError(msg)
        print(msg, flush=True)
        out[mode] = dict(ms=runs[-1][0] * 1e3, iterations=runs[-1][1])
    return out


def _bvh_cli(render_image):
    """[bvh] through the CLI: --accel bvh on the 4,802-triangle OBJ of
    [cli] 5, the card against the CPU by the 99% rule (rtol=1e-4,
    atol=1e-5), with no traversal-kernel launch; then one 960x540, 1
    spp, depth-8 frame of it, with its seconds."""
    import torch
    from pathtracing_tpu_torch.__main__ import main as cli
    from pathtracing_tpu_torch.sensor.film import finalize
    out = Path("chiprun_out") / "bvh"
    out.mkdir(parents=True, exist_ok=True)
    obj = out / "grid.obj"
    _small_grid_obj(obj)
    base = ["render", "--model", str(obj), "--accel", "bvh", "--env-light",
            "0.5", "--sun", "2", "--look-from", "2.5,3,-2", "--look-at",
            "2.5,0,2.5"]
    small = ["--resolution", "48", "36", "--spp", "4", "--max-depth", "4"]
    _reset_counts()
    card = cli(base + small + ["--out", str(out / "grid_card.ppm")])
    launches = sum(_launch_counts().values())
    cpu = cli(base + small + ["--device", "cpu", "--out",
                              str(out / "grid_cpu.ppm")])
    got = finalize(card["film"]).cpu()
    want = finalize(cpu["film"])
    frac = float(torch.isclose(got, want, rtol=1e-4, atol=1e-5).float()
                 .mean())
    print(f"[bvh] CLI --accel bvh on the 4,802-tri OBJ 48x36 4 spp d4: "
          f"accel {card['meta'].accel}, card vs CPU {frac:.3%} of values "
          f"agree, traversal-kernel launches {launches}", flush=True)
    if (card["meta"].accel != "bvh" or frac <= 0.99 or launches
            or not torch.isfinite(got).all()):
        raise RuntimeError("the CLI's --accel bvh render failed its checks")
    t0 = time.perf_counter()
    r = cli(base + ["--resolution", str(BVH_RES[0]), str(BVH_RES[1]),
                    "--spp", "1", "--max-depth", "8", "--regen", "--out",
                    str(out / "grid_frame.ppm")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    img = finalize(r["film"])
    mean = float(img.mean())
    print(f"[bvh] CLI --accel bvh {BVH_RES[0]}x{BVH_RES[1]} 1 spp d8 "
          f"--regen: render "
          f"{r['times']['render_s']:.2f}s (whole run {wall:.2f}s, build "
          f"{r['times']['build_s']:.2f}s), RenderTimer "
          f"{json.dumps(r['metrics'])}, image mean {mean:.5f}", flush=True)
    if not (torch.isfinite(img).all() and mean > 0.0):
        raise RuntimeError("the --accel bvh frame is not sound")
    return dict(frame_s=r["times"]["render_s"], card_vs_cpu=frac)


def _bench_phase(scene, cam, meta, faithful_rate, legacy_rate, grad, card,
                 frame_rps):
    """[bench] the bench's rows that chip_smoke.py's frames do not run: its
    rays run on the faithful scene (one timed run, no warm run; its rays
    per sample beside the faithful frame's frame_rps), its bounce-kernel
    row (K1 closest on the faithful opaque tables at the main path's
    pops, with the per-ray counters and the bound), its Cornell frame at
    CORNELL_SPP samples (one timed frame, no warm frame); then these with
    the frames already run (the faithful and legacy frames, [grad]'s
    regenerating fwd+bwd) as one JSON object under this script's labels:
    each row is one run, where the bench takes the least of several
    after a warm one, so it is not the bench's line."""
    from pathtracing_tpu_torch import bench
    rps, rays_rate = bench.bench_mesh_rays(scene, cam, meta, DEPTH_FAITHFUL,
                                           True, warm=False)
    print(f"[bench] rays run: {rps:.3f} rays per camera sample against the "
          f"faithful frame's {frame_rps:.3f} ({rps / frame_rps - 1:+.2%})",
          flush=True)
    kstats = bench.bench_bounce_kernel(scene, meta)
    if not kstats:
        raise RuntimeError("the faithful scene gave no bounce-kernel row")
    cornell = bench.bench_cornell(spp=CORNELL_SPP, reps=1, warm=False,
                                  device="cuda")
    deep = grad[f"regen d{DEPTH_FAITHFUL} (the first queue group)"]
    rows = {
        f"faithful_frame_d{DEPTH_FAITHFUL}_samples_per_s":
            round(faithful_rate, 1),
        "rays_run_rays_per_camera_sample": round(rps, 3),
        "rays_run_rays_per_s": round(rays_rate, 1),
        "fwd_bwd_regen_d8_frame_samples_per_s":
            round(grad["regen d8"]["samples_per_s"], 1),
        f"fwd_bwd_regen_d{DEPTH_FAITHFUL}_first_group_samples_per_s":
            round(deep["samples_per_s"], 1),
        **kstats,
        f"legacy_frame_d{DEPTH}_samples_per_s": round(legacy_rate, 1),
        f"cornell_512_d8_{CORNELL_SPP}spp_samples_per_s": round(cornell, 1),
    }
    print(f"[bench] rows of one run each (not the bench's line) on {card}:",
          flush=True)
    print(json.dumps({"chip_smoke_bench_rows": rows}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# [cli]: the command line and what it reaches
# ---------------------------------------------------------------------------

LEGACY_CAM = ("6,26,6", "60,2,60", 65.0)    # look-from, look-at, fov (deg)
HDR_SKY = (2048, 1024)                      # the HDR frame's sky, W x H
SHARD_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_parallel.py's


def _glb_bytes(meshes):
    """A binary glTF of `meshes`: (positions [V,3] f32, indices [F,3],
    (base rgb, roughness)) each, one node, one mesh and one material per
    entry (factors only: no image, so no Pillow is needed to load it)."""
    import numpy as np
    blob, views, accs, nodes, gmeshes, mats = b"", [], [], [], [], []
    for k, (pos, idx, (rgb, rough)) in enumerate(meshes):
        pos = np.ascontiguousarray(pos, np.float32)
        idx = np.ascontiguousarray(idx, np.uint32).reshape(-1)
        for arr, typ, comp in ((pos, "VEC3", 5126), (idx, "SCALAR", 5125)):
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": arr.nbytes})
            acc = {"bufferView": len(views) - 1, "componentType": comp,
                   "count": len(arr), "type": typ}
            if typ == "VEC3":
                acc.update(min=pos.min(0).tolist(), max=pos.max(0).tolist())
            accs.append(acc)
            blob += arr.tobytes()
        gmeshes.append({"primitives": [{
            "attributes": {"POSITION": len(accs) - 2},
            "indices": len(accs) - 1, "material": k}]})
        mats.append({"pbrMetallicRoughness": {
            "baseColorFactor": [*map(float, rgb), 1.0],
            "roughnessFactor": float(rough), "metallicFactor": 0.0}})
        nodes.append({"mesh": k})
    g = {"asset": {"version": "2.0"}, "scene": 0,
         "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
         "meshes": gmeshes, "materials": mats,
         "buffers": [{"byteLength": len(blob)}], "bufferViews": views,
         "accessors": accs}
    js = json.dumps(g).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def _legacy_glb(path, n_tris=N_TRIS):
    """sanmiguel_analog(faithful=False)'s geometry (scenes.py) as a .glb:
    the displaced terrain grid of n_tris triangles and the four wall
    quads (as 8 triangles), with its two diffuse materials."""
    import numpy as np
    from pathtracing_tpu_torch.scenes import _sm_height
    side = max(2, int(math.isqrt(n_tris // 2)) + 1)
    xs = np.linspace(0.0, 100.0, side, dtype=np.float32)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    v = np.stack([x, _sm_height(x, z), z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1),
                       indexing="ij")
    a = (i * side + j).ravel()
    f = np.concatenate([np.stack([a, a + 1, a + side], -1),
                        np.stack([a + 1, a + side + 1, a + side], -1)], 0)
    walls = []
    for q, u in (([0, -5, 0], [100, 0, 0]), ([0, -5, 100], [100, 0, 0]),
                 ([0, -5, 0], [0, 0, 100]), ([100, -5, 0], [0, 0, 100])):
        q, u, w = np.float32(q), np.float32(u), np.float32([0, 30, 0])
        walls += [q, q + u, q + u + w, q + w]
    wv = np.stack(walls)
    wf = np.concatenate([[[4 * k, 4 * k + 1, 4 * k + 2],
                          [4 * k, 4 * k + 2, 4 * k + 3]] for k in range(4)])
    Path(path).write_bytes(_glb_bytes([
        (v, f, ((0.62, 0.55, 0.45), 0.8)), (wv, wf, ((0.55, 0.42, 0.32),
                                                     0.9))]))
    return len(f) + len(wf)


def _hdr_sky(path):
    """A procedural HDR sky (HDR_SKY texels: a horizon gradient and a
    bright sun disc) written with io/hdr.write_hdr."""
    import numpy as np
    from pathtracing_tpu_torch.io.hdr import write_hdr
    w, h = HDR_SKY
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[..., None]
    img = (0.25 + 0.9 * up) * np.asarray([0.45, 0.6, 1.0]) \
        + (1.0 - up) * np.asarray([0.35, 0.3, 0.25])
    sun = ((u - 0.3) ** 2 + (v - 0.2) ** 2) < 0.0006
    img[sun] = (60.0, 55.0, 45.0)
    write_hdr(path, img.astype(np.float32))


def _small_grid_obj(path):
    """An OBJ of 4,802 triangles (a 50 x 50 vertex grid), its rows split
    between four MTL materials, one of them emissive."""
    lines = ["mtllib grid.mtl"]
    side = 50
    for i in range(side):
        for j in range(side):
            lines.append(f"v {i * 0.1} {0.05 * math.sin(i * 0.7 + j)} "
                         f"{j * 0.1}")
    for i in range(side - 1):
        lines.append("usemtl " + ("red", "grey", "mirror", "glow")[i % 4])
        for j in range(side - 1):
            a = i * side + j + 1
            lines.append(f"f {a} {a + 1} {a + side}\n"
                         f"f {a + 1} {a + side + 1} {a + side}")
    Path(path).write_text("\n".join(lines) + "\n")
    Path(path).with_name("grid.mtl").write_text(
        "newmtl red\nKd 0.8 0.2 0.1\nNs 100\nnewmtl grey\nKd 0.5 0.5 0.5\n"
        "newmtl mirror\nKd 0.02 0.02 0.02\nKs 0.9 0.9 0.9\n"
        "newmtl glow\nKd 0.1 0.1 0.1\nKe 4 3 2\n")


def _small_cam(b, look_from=(2.5, 3.0, -2.0), look_at=(2.5, 0.0, 2.5)):
    """A sky and a 48x36 camera."""
    b.add_uniform_inf_light((0.4, 0.5, 0.7))
    b.set_camera(look_from, look_at, math.radians(50), (48, 36))


def _cli_small_checks(render_image, card_counts):
    """[cli] 5: the card against the CPU (_card_vs_cpu's 99% rule) on a
    native-parsed OBJ (K2, then K1 under PT_TWOLEVEL_MIN=0), a glTF
    with an emissive-textured quad, a function light with an env map;
    an interrupted --checkpoint run resumed bit-equal to one
    uninterrupted run; --adaptive's mean spp."""
    import os
    import numpy as np
    import torch
    from pathtracing_tpu_torch import RenderConfig, SamplerConfig
    from pathtracing_tpu_torch.__main__ import main as cli
    from pathtracing_tpu_torch.io import load_gltf, load_obj
    from pathtracing_tpu_torch.native.loader import native_parse_obj
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    from pathtracing_tpu_torch.scenes import cornell_box
    from pathtracing_tpu_torch.utils.checkpoint import render_with_checkpoints
    out = Path("chiprun_out") / "cli_small"
    out.mkdir(parents=True, exist_ok=True)
    cfg = RenderConfig(spp=4, max_depth=4, integrator="path",
                       regenerate=True,
                       sampler=SamplerConfig(x_samples=2, y_samples=2,
                                             seed=13))
    obj = out / "grid.obj"
    _small_grid_obj(obj)
    if native_parse_obj(obj) is None:
        raise RuntimeError("the native OBJ parser did not build or load")
    for two_level in (False, True):
        if two_level:
            os.environ["PT_TWOLEVEL_MIN"] = "0"
        try:
            b = SceneBuilder()
            stats = load_obj(obj, b)
            _small_cam(b)
            scene, cam, meta = b.build(device="cpu")
        finally:
            os.environ.pop("PT_TWOLEVEL_MIN", None)
        lvl = "K1" if two_level else "K2"
        if ("pk_l1_base" in scene) != two_level or meta.accel != "pallas":
            raise RuntimeError(f"the OBJ's tables are not {lvl}'s")
        counts = {}
        _card_vs_cpu(render_image, scene, cam, meta, cfg,
                     f"[cli] OBJ {stats['n_tris']:,} tris (native parser) on "
                     f"{lvl}, 48x36", counts=counts)
        _need(counts, ("trace2[closest]",) if two_level
              else ("trace1[closest]",), f"the OBJ render on {lvl}")
        for k, v in counts.items():
            card_counts[k] = card_counts.get(k, 0) + v

    # glTF + an emissive quad textured through the builder's pool
    glb = out / "terrain.glb"
    _legacy_glb(glb, n_tris=20_000)
    b = SceneBuilder()
    load_gltf(glb, b, scale=0.1)
    texel = np.random.default_rng(5).uniform(0.0, 6.0, (16, 16, 3))
    tid = b.textures.add_image(texel.astype(np.float32))
    b.add_quad([3.0, 1.5, 3.0], [2.0, 0, 0], [0, 0, 2.0], emission=(1, 1, 1),
               em_tex=tid)
    _small_cam(b, (1.0, 4.0, -1.0), (5.0, 0.0, 5.0))
    scene, cam, meta = b.build(device="cpu")
    if not meta.has_emissive_tex:
        raise RuntimeError("the glTF scene has no textured emitter")
    _card_vs_cpu(render_image, scene, cam, meta, cfg,
                 "[cli] glTF 20K tris + emissive-textured quad, 48x36",
                 counts=card_counts)

    # a function light and an env map
    b = SceneBuilder()
    m = b.add_diffuse((0.6, 0.55, 0.5))
    b.add_quad([-4, 0, -4], [8, 0, 0], [0, 0, 8], material=m)
    b.add_sphere([0, 1, 0], 1.0, material=b.add_dielectric(1.5))
    b.add_sphere([-2, 0.7, 1], 0.7, material=m)
    sky = np.random.default_rng(6).uniform(0.1, 1.0, (64, 128, 3))
    sky[10:16, 30:40] *= 40.0
    b.add_env_light(b.textures.add_image(sky.astype(np.float32)))
    b.add_function_inf_light(lambda d: np.stack(
        [1.0 + d[:, 1], 0.5 + 0.5 * d[:, 0] ** 2, np.full(len(d), 0.8)],
        -1), nx=128, ny=64, scale=0.5)
    b.set_camera([0, 2.5, -6], [0, 1, 0], 0.75, (48, 36))
    scene, cam, meta = b.build(device="cpu")
    _card_vs_cpu(render_image, scene, cam, meta, cfg,
                 f"[cli] env map + function light (n_env={meta.n_env}), "
                 f"48x36")

    # --checkpoint: two of four samples, interrupted, then resumed by the
    # CLI, against one uninterrupted CLI run
    base = ["render", "--scene", "cornell", "--resolution", "64", "48",
            "--max-depth", "5", "--spp", "4", "--out",
            str(out / "cornell.ppm")]
    ck = out / "ck.npz"
    render_with_checkpoints(*cornell_box(resolution=(64, 48), device="cuda"),
                            RenderConfig(spp=4, max_depth=5, sampler=
                                         SamplerConfig(x_samples=2,
                                                       y_samples=2, seed=0)),
                            2, ck, every=1)
    resumed = cli(base + ["--checkpoint", str(ck), "--checkpoint-every",
                          "1"])["film"]
    straight = cli(base)["film"]
    same = all(torch.equal(resumed[k], straight[k]) for k in ("rgb",
                                                              "weight"))
    print(f"[cli] --checkpoint: 2 of 4 samples, interrupted, resumed by the "
          f"CLI: film bit-equal to one uninterrupted run: {same}",
          flush=True)
    if not same:
        raise RuntimeError("the resumed checkpoint differs")
    # --spp 16: 4 x 4 strata (the stratified sampler's permutation loops
    # forever on sample indices past a non-power-of-two strata count, in
    # both packages, and adaptive waves go past spp; ROADMAP.md section
    # 3); the textured quad converges within ~10 waves (the Cornell box's
    # light keeps a few pixels to all 128)
    r = cli(["render", "--scene", "textured", "--resolution", "48", "36",
             "--max-depth", "5", "--spp", "16", "--adaptive", "1.5",
             "--regen", "--out", str(out / "adaptive.ppm")])
    img = r["film"]["rgb"]
    print(f"[cli] --adaptive 1.5 (textured_quad 48x36, base 4 spp, up to "
          f"128 waves): mean_spp "
          f"{r['adaptive']['mean_spp']:.2f}, traced samples "
          f"{r['adaptive']['traced_samples']:,}, finite "
          f"{bool(torch.isfinite(img).all())}", flush=True)
    if not torch.isfinite(img).all():
        raise RuntimeError("the adaptive render is not finite")


def _shard_check():
    """[cli] 6: render_sharded on a one-rank nccl group against render()
    (the regenerating schedule, several tiles)."""
    import socket
    import torch
    import torch.distributed as dist
    from pathtracing_tpu_torch import RenderConfig, render
    from pathtracing_tpu_torch.parallel.distributed import initialize
    from pathtracing_tpu_torch.parallel.mesh import make_mesh, render_sharded
    from pathtracing_tpu_torch.scenes import cornell_box
    from pathtracing_tpu_torch.sensor.film import finalize
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    info = initialize(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        scene, cam, meta = cornell_box(resolution=(96, 64), device="cuda")
        cfg = RenderConfig(spp=4, max_depth=5, rays_per_batch=1024,
                           regenerate=True)
        mesh = make_mesh()
        got = finalize(render_sharded(scene, cam, meta, cfg, mesh=mesh))
        want = finalize(render(scene, cam, meta, cfg))
        ok = torch.allclose(got, want, **SHARD_TOL)
        print(f"[cli] render_sharded on a one-rank nccl group ({info}, mesh "
              f"dp={mesh.dp} sp={mesh.sp}) against render(): max |diff| "
              f"{float((got - want).abs().max()):.3e}, within rtol=2e-4 "
              f"atol=2e-5: {ok}", flush=True)
        if not ok:
            raise RuntimeError("render_sharded disagrees with render()")
    finally:
        dist.destroy_process_group()


def _cli_phase(render_image, filmmod):
    """[cli]: the CLI on the legacy scene's geometry imported from a .glb
    (then again from its scene cache, bit-equal), an HDR-lit frame of the
    same model through the API, the small card-vs-CPU checks and the
    one-rank sharding check.  Returns the launch counts of the first CLI
    frame."""
    import gc
    import torch
    from pathtracing_tpu_torch import RenderConfig, SceneBuilder
    from pathtracing_tpu_torch.__main__ import main as cli
    from pathtracing_tpu_torch.accel import trace1, trace2
    from pathtracing_tpu_torch.io import load_gltf
    out = Path("chiprun_out")
    glb, npz, hdr = out / "cli_legacy.glb", out / "cli_legacy.npz", \
        out / "cli_sky.hdr"
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        n = _legacy_glb(glb)
        print(f"[cli] wrote {glb} ({n:,} triangles, "
              f"{glb.stat().st_size / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        look_from, look_at, fov = LEGACY_CAM
        args = ["render", "--model", str(glb), "--cache", str(npz),
                "--resolution", str(RES[0]), str(RES[1]), "--spp", "1",
                "--max-depth", str(DEPTH), "--regen", "--env-light", "0.35",
                "--sun", "3", "--look-from", look_from, "--look-at", look_at,
                "--fov", str(fov), "--out", str(out / "cli_legacy.ppm")]
        runs = []
        for k in range(2):
            _reset_counts()
            t0 = time.perf_counter()
            r = cli(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _launch_counts()
            img = filmmod.finalize(r["film"])
            mean, finite = float(img.mean()), bool(torch.isfinite(img).all())
            k1 = trace2.tri_intersect2.launches
            times = {key: round(v, 3) for key, v in r["times"].items()}
            print(f"[cli] run {k + 1} ({'from the cache' if k else 'import + '
                  'build + cache save'}): accel={r['meta'].accel} "
                  f"n_tri={r['meta'].n_tri:,}, seconds {times}, whole run "
                  f"{wall:.2f}s, K1 launches in the frame {k1} (K2 "
                  f"{trace1.tri_intersect1.launches}) by mode "
                  f"{ {m: v for m, v in counts.items() if v} }, image mean "
                  f"{mean:.5f} finite {finite}", flush=True)
            print(f"[cli] run {k + 1} RenderTimer: "
                  f"{json.dumps(r['metrics'])}", flush=True)
            if not (finite and mean > 0.0 and k1 > 0
                    and r["meta"].accel == "pallas"):
                raise RuntimeError(f"CLI run {k + 1} failed its checks")
            runs.append((r, counts))
        (r1, counts), (r2, _) = runs
        same = all(torch.equal(r1["film"][key], r2["film"][key])
                   for key in ("rgb", "weight"))
        print(f"[cli] second run's film bit-equal to the first: {same}; "
              f"cache load {r2['times']['cache_load_s']:.2f}s against "
              f"import {r1['times']['import_s']:.2f}s + build "
              f"{r1['times']['build_s']:.2f}s (+ cache save "
              f"{r1['times']['cache_save_s']:.2f}s, "
              f"{npz.stat().st_size / 2**30:.2f} GiB)", flush=True)
        if not same:
            raise RuntimeError("the cached run's film differs")
        _need(counts, ("trace2[closest]", "trace2[any_hit]"),
              "the CLI frame")
        del runs, r1, r2
        npz.unlink()
        gc.collect()

        # 4. an HDR-lit frame of the same model through the API
        t0 = time.perf_counter()
        _hdr_sky(hdr)
        t_sky = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = SceneBuilder()
        load_gltf(glb, b)
        b.add_env_light_from_file(hdr)
        b.set_camera([float(x) for x in look_from.split(",")],
                     [float(x) for x in look_at.split(",")],
                     math.radians(fov), RES)
        scene, cam, meta = b.build(device="cuda")
        torch.cuda.synchronize()
        print(f"[cli] HDR-lit scene: sky {HDR_SKY[0]}x{HDR_SKY[1]} written "
              f"in {t_sky:.2f}s; import + env tables "
              f"{meta.env_nx}x{meta.env_ny} (n_env={meta.n_env}) + build "
              f"{time.perf_counter() - t0:.2f}s, accel={meta.accel}",
              flush=True)
        if (meta.env_nx, meta.env_ny, meta.n_env) != (1024, 512, 1):
            raise RuntimeError("the HDR sky's env tables are not 1024x512")
        cfg = RenderConfig(spp=1, max_depth=DEPTH, integrator="path",
                           rays_per_batch=65536, regenerate=True)
        hdr_counts, hdr_frame = _frame(filmmod, scene, cam, meta, cfg,
                                       f"[cli] HDR-lit imported model d{DEPTH}",
                                       "cli_hdr.ppm")
        _need(hdr_counts, ("trace2[closest]", "trace2[any_hit]"),
              "the HDR-lit frame")
        del scene, cam
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for f in (glb, npz, hdr):
            f.unlink(missing_ok=True)

    # 5. small card-vs-CPU checks; 6. one-rank sharding
    small_counts = {}
    _cli_small_checks(render_image, small_counts)
    _shard_check()
    print(f"[cli] phase {time.perf_counter() - t_phase:.1f}s (HDR frame "
          f"{hdr_frame['seconds']:.2f}s, {hdr_frame['rays_per_sample']:.3f} "
          f"rays per sample)", flush=True)
    return counts


def _oracle_module():
    """tests/test_torch_independent_oracle.py: the JAX oracle test's scene,
    settings and rules on the port (it imports torch, numpy and
    tests/independent_oracle.py, nothing of JAX)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_independent_oracle
    return test_torch_independent_oracle


def _oracle_job(integrator):
    """(the oracle's image at the full settings, its seconds): run in a
    worker process on the host's CPU while the card renders."""
    t0 = time.perf_counter()
    img = _oracle_module().oracle_image(integrator)
    return img, time.perf_counter() - t0


def _oracle_render(scene, cam, meta, cfg):
    """The film's weighted mean per pixel ([H, W, 3] float64 numpy) of all
    cfg.spp samples of every pixel drained by the regenerating tracer with
    ORACLE_LANES lanes in flight.  render() would give a 32x32 frame 1,024
    lanes (512 plain waves, or a 1,152-iteration drain: 67-113 s a render
    on an H100, launch-bound); the samples and their streams are the
    same."""
    import torch
    from pathtracing_tpu_torch.integrators.render import render_tile_regen
    from pathtracing_tpu_torch.sensor import film as filmmod
    w, h = cam["resolution"]
    pix = torch.arange(w * h, device=scene["mat_base"].device)
    film = render_tile_regen(scene, cam, meta, cfg,
                             filmmod.new_film((w, h), device=pix.device), pix,
                             cfg.spp, 0, rows=h, row0=0, lanes=ORACLE_LANES)
    img = filmmod.finalize(film)
    return img.cpu().double().numpy().reshape(h, w, 3)


def _oracle_phase():
    """[oracle]: tests/independent_oracle.py held to the port on the card at
    the JAX oracle test's full settings, for `path` and `simple`; the
    oracle runs once per integrator in a worker process while the card
    renders three variants of the scene: (a) as it is (brute, no kernel),
    (b) its floor as a 16x16-cell mesh (512 triangles, accel="pallas":
    K2), (c) (b) under PT_TWOLEVEL_MIN=0 (K1), each drained by the
    regenerating tracer (_oracle_render).  Each must hold the mean within
    2% and every 4x4 block within 12%."""
    import concurrent.futures
    import multiprocessing
    import os
    import numpy as np
    orc = _oracle_module()
    t_phase = time.perf_counter()

    def scene_of(variant):
        if variant == "c":
            os.environ["PT_TWOLEVEL_MIN"] = "0"
        try:
            if variant == "a":
                return orc.build_scene("cuda")
            return orc.build_scene("cuda", floor_cells=ORACLE_FLOOR_CELLS,
                                   accel="pallas")
        finally:
            os.environ.pop("PT_TWOLEVEL_MIN", None)

    kernel = dict(a=None, b="trace1", c="trace2")
    renders = {}
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {i: pool.submit(_oracle_job, i) for i in orc.FULL}
        for variant in "abc":
            scene, cam, meta = scene_of(variant)
            levels = ("two-level" if "pk_l1_base" in scene else
                      "single-level" if "pk_tri" in scene else "none")
            for integrator, s in orc.FULL.items():
                cfg = orc.port_config(integrator, s["spp"], s["grid"],
                                      s["seed"])
                _reset_counts()
                t0 = time.perf_counter()
                img = _oracle_render(scene, cam, meta, cfg)
                seconds = time.perf_counter() - t0
                counts = {k: v for k, v in _launch_counts().items() if v}
                k = kernel[variant]
                if k is None and counts:
                    raise RuntimeError(f"[oracle] (a) launched {counts}")
                if k is not None:       # `simple` traces no shadow rays
                    _need(counts, [f"{k}[closest]"] + (
                        [f"{k}[any_hit]"] if integrator == "path" else []),
                        f"[oracle] ({variant}) {integrator}")
                renders[variant, integrator] = (img, seconds, counts,
                                                meta.accel, meta.n_tri,
                                                levels)
            del scene
        oracles = {i: job.result() for i, job in jobs.items()}
    for (variant, integrator), (img, seconds, counts, accel, n_tri,
                                levels) in renders.items():
        oracle, oracle_s = oracles[integrator]
        rel, worst = orc.errors(img, oracle)
        s = orc.FULL[integrator]
        print(f"[oracle] ({variant}) {integrator}: {n_tri} triangles, accel="
              f"{accel} ({levels} tables), {orc.RES[0]}x{orc.RES[1]} x "
              f"{s['spp']} spp depth {orc.MAX_DEPTH} seed {s['seed']} "
              f"(regenerating, {ORACLE_LANES} lanes) in {seconds:.2f}s "
              f"({orc.RES[0] * orc.RES[1] * s['spp'] / seconds:.1f} "
              f"samples/s); mean {img.mean():.6f} vs the oracle's "
              f"{oracle.mean():.6f} ({s['oracle_spp']} spp, generator "
              f"{s['oracle_seed']}, {oracle_s:.2f}s on the host's CPU): off "
              f"by {rel:.3%} (gate {orc.MEAN_TOL:.0%}), worst 4x4 block off "
              f"by {worst:.3%} (gate {orc.BLOCK_TOL:.0%}); launches "
              f"{counts}", flush=True)
        if not (np.isfinite(img).all() and rel < orc.MEAN_TOL
                and worst < orc.BLOCK_TOL):
            raise RuntimeError(f"[oracle] ({variant}) {integrator} disagrees "
                               f"with the independent oracle")
    print(f"[oracle] phase {time.perf_counter() - t_phase:.1f}s", flush=True)


def _example_phase(render_image):
    """[example]: the API walkthrough (tools/example_1.py) through its main
    on the card at EXAMPLE_RES x EXAMPLE_SPP, then its scene card against
    CPU by the 99% rule at 48x36, 4 spp, under its own config."""
    import torch
    from pathtracing_tpu_torch.sensor import film as filmmod
    from pathtracing_tpu_torch.tools import example_1
    t_phase = time.perf_counter()
    _reset_counts()
    r = example_1.main(["--res", *map(str, EXAMPLE_RES), "--spp",
                        str(EXAMPLE_SPP), "--out",
                        "chiprun_out/example_1.ppm"])
    img = filmmod.finalize(r["film"])
    mean, finite = float(img.mean()), bool(torch.isfinite(img).all())
    launches = sum(_launch_counts().values())
    print(f"[example] tools/example_1.main at {EXAMPLE_RES[0]}x"
          f"{EXAMPLE_RES[1]} x {EXAMPLE_SPP} spp, volpath depth 8: "
          f"{r['seconds']:.2f}s, {r['samples_per_s']:.1f} samples/s, image "
          f"mean {mean:.6f} finite {finite}, kernel launches {launches} "
          f"(seven analytic prims: the brute scan)", flush=True)
    if not (finite and mean > 0.0):
        raise RuntimeError(f"[example] bad image: mean={mean} "
                           f"finite={finite}")
    _card_vs_cpu(render_image, *example_1.build_scene((48, 36), "cpu"),
                 example_1.render_config(spp=4, depth=8),
                 "[example] example_1.build_scene 48x36 4 spp volpath d8")
    print(f"[example] phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)


class _Tee:
    """stdout that also lands in a file, so a long output is kept whole;
    the file's lines start with the seconds since the script began (the
    phases' times)."""

    def __init__(self, stream, path, t0):
        self.stream, self.file, self.t0 = stream, open(path, "w"), t0
        self.line_start = True

    def write(self, text):
        for piece in text.splitlines(keepends=True):
            if self.line_start:
                self.file.write(f"[{time.perf_counter() - self.t0:7.1f}s] ")
            self.file.write(piece)
            self.line_start = piece.endswith("\n")
        self.file.flush()
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def main() -> int:
    import argparse
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more frame with torch.profiler "
                    "(device busy share, top device kernels); its event "
                    "processing takes minutes, so it is not on by default")
    ap.add_argument("--sections", action="store_true",
                    help="also render one more faithful frame with a timer "
                    "and a device synchronize around each section of the "
                    "bounce loop, and print each section's share; and run "
                    "the [grad] phase's regenerating fwd+bwd once more with "
                    "a timer around each section of the backward pass")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    Path("chiprun_out").mkdir(exist_ok=True)
    sys.stdout = _Tee(sys.stdout, Path("chiprun_out") / "chip_smoke.log",
                      t_start)
    import os
    from pathtracing_tpu_torch import RenderConfig, SamplerConfig, render, \
        render_image
    from pathtracing_tpu_torch.accel import cubuild, trace1, trace2
    from pathtracing_tpu_torch.native.loader import native_available
    from pathtracing_tpu_torch.scene import builder
    from pathtracing_tpu_torch.scene.intersect import _subset_scene
    from pathtracing_tpu_torch.scene.intersect import _multipass_visits
    from pathtracing_tpu_torch.scenes import (cornell_box, sanmiguel_analog,
                                              spheres_medium, textured_quad)
    from pathtracing_tpu_torch.tools import bench_leaf
    from pathtracing_tpu_torch.sensor import film as filmmod

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    import importlib.util
    import shutil
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} card: {card} | nvcc "
          f"{shutil.which('nvcc') or Path('/usr/local/cuda/bin/nvcc')}"
          f" g++ {shutil.which('g++')} triton "
          f"{importlib.util.find_spec('triton') is not None} | native SAH "
          f"builder: {native_available()}", flush=True)

    def on_card(tabs):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in tabs.items()}

    # ---- 1. build (one nvcc per source, started together; K4 also in
    # the scalar modes' other lane counts, for its lanes A/B)
    t0 = time.perf_counter()
    cubuild.build_all(("trace2", "trace1", "leaf") + tuple(
        ("leaf", bench_leaf.build_defines(lanes=w)) for w in bench_leaf.LANES
        if w != bench_leaf.DEFAULT_LANES))
    trace2.build_kernel()
    trace1.build_kernel()
    bench_leaf.build_kernel()
    print(f"[build] trace2.cu + trace1.cu + leaf.cu built+loaded in "
          f"{time.perf_counter() - t0:.2f}s ({cubuild.BUILD_SECONDS})",
          flush=True)
    for stem in ("trace2", "trace1", "leaf"):
        for name, line in cubuild.kernel_resources(stem):
            print(f"[build] {stem} {name}: {line}", flush=True)
    for mode in trace2.MODES:
        print(f"[occupancy] trace2 {mode}: group kernel "
              f"{trace2.occupancy(mode)} blocks of 128 per SM unstaged "
              f"(each [kernel] row gives it with its tables staged), window "
              f"kernel {trace2.occupancy(mode, window=True)}", flush=True)
    for mode in ("closest", "amask1", "amask2", "inst_closest",
                 "motion_closest"):
        print(f"[occupancy] trace1 {mode} (and its any-hit): "
              f"{trace1.occupancy(mode)} blocks of 128 per SM unstaged (each "
              f"[kernel] row gives it with its tables staged)", flush=True)

    kern = {}       # "trace2[mode]" / "trace1[mode]" -> measured numbers

    # ---- 2a. random soup, closest + any-hit, K1 and K2 (cut to its size)
    rng = np.random.default_rng(13)
    nt = 200_000
    tri_v = _soup_tris(rng, nt)
    n = 65536
    o, d = _shell_rays(rng, n, dev)
    big = torch.full((n,), 3e38, device=dev)
    soup = on_card(trace2.build_tri_blocks2(tri_v, g=32)[0])
    soup["tri_v"] = torch.from_numpy(tri_v).to(dev)
    _compare(trace2, soup, o, d, big, "K1 soup 200K tris x 64K rays",
             prune=False)
    # K1's new modes: schedules against the window=1 walk (itself held to
    # the brute force just above), caps against the brute capped walk
    _compare_schedules(soup, o, d, big, "K1 soup 200K tris x 64K rays")
    _compare_caps(soup, o, d, big, "K1 soup 200K tris x 64K rays",
                  prune=False)
    soup = on_card(trace1.build_tri_blocks(tri_v[:65536])[0])
    soup["tri_v"] = torch.from_numpy(tri_v[:65536]).to(dev)
    _compare(trace1, soup, o, d, big, "K2 soup 65,536 tris x 64K rays",
             prune=False)
    del soup

    # ---- 2b. alpha-card soup, amask 1 + 2 against the brute force
    nr = (65536 // RES[0]) * RES[0]          # 34 rows x 1920 = 65,280 lanes
    o, d = _shell_rays(rng, nr, dev)
    big = torch.full((nr,), 3e38, device=dev)
    cards = _card_soup(np.random.default_rng(17), 100_000, dev, trace2)
    _compare_amask(trace2, cards, o, d, big, "K1 card soup 200K tris",
                   prune=False)
    cards = _card_soup(np.random.default_rng(17), 32_768, dev, trace1)
    _compare_amask(trace1, cards, o, d, big, "K2 card soup 65,536 tris",
                   prune=False)
    del cards

    # ---- 2e. synthetic instanced and moving soups
    rng = np.random.default_rng(29)
    ov = np.concatenate([_soup_tris(rng, 96, 3.0, 1.0),
                         _soup_tris(rng, 200, 4.0, 1.0)])
    fw = [_xf(rng) for _ in range(300)]
    iv = [np.linalg.inv(f).astype(np.float32) for f in fw]
    wv = _soup_tris(rng, 20_000)
    iargs = (wv, ov, [f[:3, :4] for f in fw], [f[:3, :4] for f in iv],
             [0] * 200 + [96] * 100, [96] * 200 + [200] * 100)
    wvel = rng.normal(0, 3.0, (len(wv), 3)).astype(np.float32)
    ivel = rng.normal(0, 3.0, (300, 3)).astype(np.float32)
    times = torch.from_numpy(rng.uniform(0, 1, nr).astype(np.float32)).to(dev)
    mv = _soup_tris(rng, 60_000)
    mvel = rng.normal(0, 3.0, (len(mv), 3)).astype(np.float32)
    shut = (0.0, 1.0)
    tabs = on_card(trace2.build_tri_blocks2_inst(*iargs, g=32)[0])
    r = _measure(trace2, tabs, o, d, big, "K1 instanced soup (300 instances "
                 "+ 20K world tris)", ("closest", "any_hit"), brute_rays=8192)
    _compare_schedules(tabs, o, d, big, "K1 instanced soup")
    _compare_caps(tabs, o, d, big, "K1 instanced soup")
    kern["trace2[inst_closest]"] = r["closest"]
    kern["trace2[inst_any_hit]"] = r["any_hit"]
    tabs = on_card(trace2.build_tri_blocks2_inst(
        *iargs, g=32, tri_vel=wvel, inst_vel=ivel, shutter=shut)[0])
    r = _measure(trace2, tabs, o, d, big, "K1 instanced + motion soup",
                 ("closest", "any_hit"), brute_rays=8192, time=times)
    _compare_schedules(tabs, o, d, big, "K1 instanced + motion soup",
                       time=times)
    _compare_caps(tabs, o, d, big, "K1 instanced + motion soup", time=times)
    kern["trace2[inst_motion_closest]"] = r["closest"]
    kern["trace2[inst_motion_any_hit]"] = r["any_hit"]
    tabs = on_card(trace2.build_tri_blocks2(mv, g=32, tri_vel=mvel,
                                            shutter=shut)[0])
    r = _measure(trace2, tabs, o, d, big, "K1 motion soup 60K tris",
                 ("closest", "any_hit"), brute_rays=8192, time=times)
    _compare_schedules(tabs, o, d, big, "K1 motion soup", time=times)
    _compare_caps(tabs, o, d, big, "K1 motion soup", time=times)
    kern["trace2[motion_closest]"] = r["closest"]
    kern["trace2[motion_any_hit]"] = r["any_hit"]
    tabs = on_card(trace1.build_tri_blocks_inst(*iargs)[0])
    r = _measure(trace1, tabs, o, d, big, "K2 instanced soup (300 instances "
                 "+ 20K world tris)", ("closest", "any_hit"), brute_rays=8192)
    kern["trace1[inst_closest]"] = r["closest"]
    kern["trace1[inst_any_hit]"] = r["any_hit"]
    tabs = on_card(trace1.build_tri_blocks(mv, tri_vel=mvel, shutter=shut)[0])
    r = _measure(trace1, tabs, o, d, big, "K2 motion soup 60K tris",
                 ("closest", "any_hit"), brute_rays=8192, time=times)
    kern["trace1[motion_closest]"] = r["closest"]
    kern["trace1[motion_any_hit]"] = r["any_hit"]
    del tabs, o, d, big, times

    # ---- 2c. full-size legacy tables, closest + any-hit
    t0 = time.perf_counter()
    scene, cam, meta = sanmiguel_analog(resolution=RES, n_tris=N_TRIS,
                                        faithful=False, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[scene] sanmiguel_analog(faithful=False): {meta.n_tri:,} tris "
          f"+ {meta.n_quad} quads, accel={meta.accel}, K2={meta.block_k}, "
          f"G={meta.block_g}, L1={scene['pk_l1box'].shape[0]}, "
          f"build {build_s:.1f}s", flush=True)
    # the culled plain version below is sound only if every child box
    # holds its triangles (padded children: far-point boxes)
    if not trace2.child_boxes_hold_triangles(scene, scene["tri_v"]):
        raise RuntimeError("a child box does not hold its triangles")
    print("[tables] every child box holds its triangles' vertices; padded "
          "children are far-point boxes", flush=True)
    o64, d64 = _bounce_rays(scene, nr)
    t64 = torch.full((nr,), 1e30, device=dev)
    label = f"K1 {meta.n_tri:,}-tri tables x {nr} bounce rays"
    r = _measure(trace2, scene, o64, d64, t64, label, ("closest", "any_hit"))
    kern["trace2[closest]"] = r["closest"]
    kern["trace2[any_hit]"] = r["any_hit"]

    # ---- [bvh] the accel="bvh" backend on the same tables and rays, then
    # through the CLI
    _bvh_phase(scene, meta, o64, d64, r["closest"]["ms"])
    del o64, d64
    _bvh_cli(render_image)

    # ---- 3. card numerics vs the port's CPU numerics, small scenes
    small = RenderConfig(spp=2, max_depth=4, integrator="path",
                         regenerate=True,
                         sampler=SamplerConfig(x_samples=2, y_samples=1,
                                               seed=3))
    _card_vs_cpu(render_image, *sanmiguel_analog(
        resolution=(64, 36), n_tris=20_000, faithful=False, device="cpu"),
        small, "sanmiguel_analog(faithful=False) 20K tris 64x36")
    _card_vs_cpu(render_image, *cornell_box(resolution=(32, 32),
                                            device="cpu"),
                 RenderConfig(spp=8, max_depth=4, integrator="path",
                              sampler=SamplerConfig(x_samples=4, y_samples=2,
                                                    seed=11)),
                 "cornell_box 32x32")
    _card_vs_cpu(render_image, *textured_quad(resolution=(24, 24),
                                              device="cpu"),
                 RenderConfig(spp=4, max_depth=3, integrator="path",
                              sampler=SamplerConfig(x_samples=2, y_samples=2,
                                                    seed=11)),
                 "textured_quad 24x24")
    mini = sanmiguel_analog(resolution=(64, 36), n_tris=20_000, foliage=32,
                            faithful=True, device="cpu")
    # The faithful scene's normal map turns the shading normal by ~0.5 rad
    # per texel, so one-ulp differences between the card's and the CPU's
    # float32 kernels decorrelate a path within a few bounces (PERF.md);
    # the 99% rule is held at depth 2, deeper renders are reported.
    _card_vs_cpu(render_image, *mini, dataclasses.replace(small, max_depth=2),
                 "sanmiguel_analog(faithful=True) 20K tris + 32 shrubs 64x36 "
                 "depth 2")
    _card_vs_cpu(render_image, *mini, small,
                 "sanmiguel_analog(faithful=True) 20K tris + 32 shrubs 64x36 "
                 "depth 4", min_frac=0.0)
    _occluded_card_vs_cpu(*mini)
    # the same miniature with its shrubs kept as run-time instances
    os.environ["PT_FLATTEN_MAX"] = "0"
    mini = sanmiguel_analog(resolution=(64, 36), n_tris=20_000, foliage=32,
                            faithful=True, device="cpu")
    del os.environ["PT_FLATTEN_MAX"]
    if mini[2].n_inst != 32 or "pka_blk_src" not in mini[0]:
        raise RuntimeError("PT_FLATTEN_MAX=0 did not keep the shrubs as "
                           "run-time instances")
    _card_vs_cpu(render_image, *mini, dataclasses.replace(small, max_depth=2),
                 "sanmiguel_analog(faithful=True, run-time instances) 20K "
                 "tris + 32 shrubs 64x36 depth 2")
    _occluded_card_vs_cpu(*mini, label="run-time instances")
    del mini
    # run-time instances and motion on small scenes; the launches of these
    # card renders are the path's count for the modes no full frame runs
    small_counts = {}
    cfg_c = RenderConfig(spp=4, max_depth=3, integrator="path",
                         regenerate=True,
                         sampler=SamplerConfig(x_samples=2, y_samples=2,
                                               seed=5))
    for kind, what in (("inst", "three run-time instances + world tris "
                        "(single-level instanced tables)"),
                       ("moving_mesh", "a moving 5,202-tri mesh "
                        "(single-level tables with velocities)"),
                       ("moving_inst", "a moving run-time instance + moving "
                        "world tris (two-level instanced tables)"),
                       ("inst_big", "three run-time instances over 72,200 "
                        "world tris (two-level instanced tables)"),
                       ("moving_mesh_k1", "the moving mesh with TWOLEVEL_MIN "
                        "= 0 (two-level tables with velocities)")):
        _card_vs_cpu(render_image, *_pyramid_scene(kind), cfg_c,
                     f"{what} 48x48", counts=small_counts)
    # volpath: the scene's own analytic prims (no kernel), then a medium
    # bounded by a 4,992-triangle mesh through K2 and through K1 (K1's
    # render under PT_WINDOW=2: the only launches of that schedule)
    cfg_v = RenderConfig(spp=4, max_depth=4, integrator="volpath",
                         regenerate=True,
                         sampler=SamplerConfig(x_samples=2, y_samples=2,
                                               seed=7))
    cfg_vm = dataclasses.replace(cfg_v, spp=2, sampler=SamplerConfig(
        x_samples=2, y_samples=1, seed=7))
    _card_vs_cpu(render_image, *spheres_medium(resolution=(48, 48),
                                               device="cpu"), cfg_v,
                 "volpath spheres_medium 48x48")
    vol_counts = {}
    _card_vs_cpu(render_image, *_medium_mesh_scene(False), cfg_vm,
                 "volpath medium bounded by a 4,992-tri mesh, K2, 48x48",
                 counts=vol_counts)
    os.environ["PT_WINDOW"] = "2"
    _card_vs_cpu(render_image, *_medium_mesh_scene(True), cfg_vm,
                 "volpath medium bounded by a 4,992-tri mesh, K1 "
                 "(TWOLEVEL_MIN = 0, PT_WINDOW=2), 48x48", counts=vol_counts)
    del os.environ["PT_WINDOW"]
    # (volpath's shadow rays march with closest-hit passes: no any-hit)
    _need(vol_counts, ("trace1[closest]", "trace2[closest]",
                       "trace2[window2]"), "the volpath mesh renders")
    for k, v in vol_counts.items():
        small_counts[k] = small_counts.get(k, 0) + v
    print(f"[card-vs-cpu] launches of the small card renders: "
          f"{ {k: v for k, v in small_counts.items() if v} }", flush=True)
    _need(small_counts, ("trace1[inst_closest]", "trace1[inst_any_hit]",
                         "trace1[motion_closest]", "trace1[motion_any_hit]",
                         "trace2[inst_motion_closest]",
                         "trace2[inst_motion_any_hit]",
                         "trace2[inst_closest]", "trace2[inst_any_hit]",
                         "trace2[motion_closest]", "trace2[motion_any_hit]"),
          "the small renders")

    # ---- 4. the legacy path, through the public entry point
    # as bench.py renders the legacy cell: default 4x4 stratified sampler
    cfg = RenderConfig(spp=1, max_depth=DEPTH, integrator="path",
                       rays_per_batch=65536, regenerate=True)
    legacy, legacy_frame = _frame(filmmod, scene, cam, meta, cfg,
                                  f"legacy path d{DEPTH}",
                                  "sanmiguel_legacy.ppm")
    _need(legacy, ("trace2[closest]", "trace2[any_hit]"), "the legacy render")
    del scene

    # ---- 5. the faithful path (foliage flattened to world triangles)
    def build_faithful(label, n_tris=N_TRIS, foliage=FOLIAGE):
        t0 = time.perf_counter()
        scene, cam, meta = sanmiguel_analog(resolution=RES, n_tris=n_tris,
                                            foliage=foliage, faithful=True,
                                            device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        bs = builder.BUILD_SECONDS
        n_alpha = int((scene["pka_slot2tri"] >= 0).sum())
        lvl = {p: ("two-level" if p + "l1_base" in scene else "single-level")
               + (" instanced" if p + "blk_src" in scene else "")
               for p in ("pk_", "pka_")}
        print(f"[scene] {label}: {meta.n_tri:,} world tris + {meta.n_inst} "
              f"run-time instances of {meta.n_obj_tri} object tris + "
              f"{meta.n_sph} spheres + {meta.n_quad} quads, {meta.n_lights} "
              f"lights, accel={meta.accel}; opaque tables {lvl['pk_']} K="
              f"{meta.block_k} top-level boxes={scene['pk_blk_lo'].shape[0]}"
              f", alpha tables {lvl['pka_']} K={meta.alpha_block_k} "
              f"top-level boxes={scene['pka_blk_lo'].shape[0]} data slots="
              f"{n_alpha:,} G={meta.block_g}, alpha_cull_mask="
              f"{meta.alpha_cull_mask}; build {build_s:.1f}s (mask build "
              f"{bs['masks']:.2f}s, tables {bs['tables']:.1f}s, scene arrays "
              f"+ upload {build_s - bs['masks'] - bs['tables']:.1f}s)",
              flush=True)
        if not meta.alpha_cull_mask:
            raise RuntimeError(f"{label} has no masked alpha tables")
        return scene, cam, meta, n_alpha

    scene, cam, meta, n_alpha = build_faithful(
        "sanmiguel_analog(faithful=True)")
    if n_alpha != FOLIAGE * 96 or meta.n_inst:
        raise RuntimeError("the faithful scene's foliage was not flattened")
    alpha = _subset_scene(scene, "pka_")

    # ---- 2d. K1 amask 1 + 2 on the full alpha tables
    if not trace2.child_boxes_hold_triangles(alpha, scene["tri_v"]):
        raise RuntimeError("an alpha child box does not hold its triangles")
    of, df = _foliage_rays(scene, nr)
    tf_ = torch.full((nr,), 1e30, device=dev)
    label = f"K1 {n_alpha:,}-tri alpha tables x {nr} foliage rays"
    r = _measure(trace2, alpha, of, df, tf_, label, ("amask1", "amask2"))
    kern["trace2[amask1]"] = r["amask1"]
    kern["trace2[amask2]"] = r["amask2"]
    # the window walk as path C runs it on these passes
    _compare_schedules(alpha, of, df, tf_, label, amasks=(1, 2))
    kern.update(_measure_windows(alpha, of, df, tf_, label))
    del alpha

    cfg = RenderConfig(spp=1, max_depth=DEPTH_FAITHFUL, integrator="path",
                       rays_per_batch=65536, regenerate=True)
    faithful, flat = _frame(filmmod, scene, cam, meta, cfg,
                            f"faithful path d{DEPTH_FAITHFUL} (flattened "
                            f"foliage)", "sanmiguel_faithful.ppm")
    _need(faithful, [f"trace2[{m}]" for m in ("closest", "any_hit", "amask1",
                                              "amask2")],
          "the faithful render")
    if args.sections:
        _sections_frame(render, scene, cam, meta, cfg)
    if args.profile:
        _profile_frame(render, scene, cam, meta, cfg)

    # ---- 2h. K1's new modes on the 10.5M-triangle faithful tables
    ob, db = _bounce_rays(scene, nr)
    tb_ = torch.full((nr,), 1e30, device=dev)
    label = (f"K1 faithful {meta.n_tri - n_alpha:,}-tri opaque tables x {nr} "
             f"bounce rays")
    _compare_schedules(scene, ob, db, tb_, label)
    _compare_caps(scene, ob, db, tb_, label)
    m1pad = -(-scene["pk_l1box"].shape[0] // 128) * 128
    print(f"[multipass] opaque tables: {scene['pk_l1box'].shape[0]} L1s, "
          f"m1pad {m1pad} (the driver runs at <= 8192)", flush=True)
    _multipass_check(scene, ob, db, tb_, label)
    kern.update(_measure_schedules(scene, ob, db, tb_, label))
    del ob, db, tb_
    _key_order(scene, nr, label)

    # ---- 5b. path C: the same frame under PT_MULTIPASS and PT_WINDOW
    os.environ["PT_MULTIPASS"] = ",".join(str(v) for v in MULTIPASS)
    os.environ["PT_WINDOW"] = "4"
    if _multipass_visits() != MULTIPASS:
        raise RuntimeError("PT_MULTIPASS was not read")
    cfg_ac = dataclasses.replace(cfg, max_depth=DEPTH_AC)
    try:
        path_c, mpw = _frame(filmmod, scene, cam, meta, cfg_ac,
                             f"path C d{DEPTH_AC} (flattened foliage, "
                             f"PT_MULTIPASS={os.environ['PT_MULTIPASS']} "
                             f"PT_WINDOW=4)", "sanmiguel_multipass.ppm")
    finally:
        del os.environ["PT_MULTIPASS"], os.environ["PT_WINDOW"]
    _need(path_c, ("trace2[capped]", "trace2[frontier]", "trace2[window4]",
                   "trace2[window4_amask1]", "trace2[window4_amask2]",
                   "trace2[amask1]", "trace2[amask2]"), "path C")
    # (path C at depth 32 against the faithful frame at 64: bounces past
    # 32 are a small share of its rays; path A is held to path C below,
    # at the same depth)
    print(f"[path C vs flattened] rays/sample {mpw['rays_per_sample']:.3f} "
          f"vs {flat['rays_per_sample']:.3f}; image mean {mpw['mean']:.5f} "
          f"vs {flat['mean']:.5f}; bounce iterations {mpw['iterations']} vs "
          f"{flat['iterations']}; frame {mpw['seconds']:.2f}s vs "
          f"{flat['seconds']:.2f}s; camera samples/s "
          f"{mpw['samples_per_s']:.1f} vs {flat['samples_per_s']:.1f}",
          flush=True)
    if not (abs(mpw["rays_per_sample"] / flat["rays_per_sample"] - 1) < 0.02
            and abs(mpw["mean"] / flat["mean"] - 1) < 0.02):
        raise RuntimeError("path C does not land beside the flattened frame")

    # ---- 5c. [grad] gradients through the renderer: the probe scene on
    # the card against the CPU, then the faithful frame's fwd+bwd
    _grad_parity(dev)
    grad = _grad_frames(scene, cam, meta, args.sections)

    # ---- [bench] the bench's rays run, bounce-kernel row and Cornell
    # frame, and its JSON line
    _bench_phase(scene, cam, meta, flat["samples_per_s"],
                 legacy_frame["samples_per_s"], grad, card,
                 flat["rays_per_sample"])
    del scene

    # ---- 6. path A: the foliage kept as run-time instances
    os.environ["PT_FLATTEN_MAX"] = "0"
    scene, cam, meta, n_alpha = build_faithful(
        "path A: sanmiguel_analog(faithful=True), PT_FLATTEN_MAX=0")
    del os.environ["PT_FLATTEN_MAX"]
    if (meta.n_inst != FOLIAGE or meta.n_obj_tri != 96 or n_alpha != 96
            or "pka_blk_src" not in scene or "pk_blk_src" in scene
            or scene["pka_l1box"].shape[0] != FOLIAGE):
        raise RuntimeError("path A's tables are not the run-time-instanced "
                           "foliage over plain opaque tables")
    # ---- 2f. K1 instanced amask 1 + 2 on the real alpha tables
    alpha = _subset_scene(scene, "pka_")
    r = _measure(trace2, alpha, of, df, tf_,
                 f"K1 instanced alpha tables ({FOLIAGE} expanded L1s, one "
                 f"stored shrub) x {nr} foliage rays", ("amask1", "amask2"))
    _compare_schedules(alpha, of, df, tf_, "K1 path A instanced alpha tables",
                       amasks=(0, 1, 2))
    _compare_caps(alpha, of, df, tf_, "K1 path A instanced alpha tables")
    kern["trace2[inst_amask1]"] = r["amask1"]
    kern["trace2[inst_amask2]"] = r["amask2"]
    del alpha
    path_a, tlas = _frame(filmmod, scene, cam, meta, cfg_ac,
                          f"path A d{DEPTH_AC} (run-time-instanced "
                          f"foliage)", "sanmiguel_tlas.ppm")
    _need(path_a, ("trace2[closest]", "trace2[any_hit]",
                   "trace2[inst_amask1]", "trace2[inst_amask2]"), "path A")
    print(f"[path A vs flattened] rays/sample {tlas['rays_per_sample']:.3f} "
          f"vs {flat['rays_per_sample']:.3f}; image mean {tlas['mean']:.5f} "
          f"vs {flat['mean']:.5f}; frame {tlas['seconds']:.2f}s vs "
          f"{flat['seconds']:.2f}s; camera samples/s "
          f"{tlas['samples_per_s']:.1f} vs {flat['samples_per_s']:.1f}",
          flush=True)
    if not (abs(tlas["rays_per_sample"] / flat["rays_per_sample"] - 1) < 0.02
            and abs(tlas["mean"] / flat["mean"] - 1) < 0.02):
        raise RuntimeError("path A does not land beside the flattened frame")
    # the same frame at the same depth: path A against path C
    print(f"[path A vs path C] both d{DEPTH_AC}: rays/sample "
          f"{tlas['rays_per_sample']:.4f} vs {mpw['rays_per_sample']:.4f}; "
          f"image mean {tlas['mean']:.6f} vs {mpw['mean']:.6f}", flush=True)
    if not (abs(tlas["rays_per_sample"] / mpw["rays_per_sample"] - 1) < 0.02
            and abs(tlas["mean"] / mpw["mean"] - 1) < 0.02):
        raise RuntimeError("path A does not land beside path C")
    del scene, of, df, tf_

    # ---- 7. path B: the small courtyard on the single-level kernel
    scene, cam, meta, n_alpha = build_faithful(
        f"path B: sanmiguel_analog(n_tris={N_TRIS_SMALL:,}, foliage="
        f"{FOLIAGE_SMALL})", N_TRIS_SMALL, FOLIAGE_SMALL)
    if ("pk_l1_base" in scene or "pka_l1_base" in scene or meta.n_inst
            or n_alpha != FOLIAGE_SMALL * 96):
        raise RuntimeError("path B's tables are not single-level")
    # ---- 2g. K2 on path B's real tables
    ob, db = _bounce_rays(scene, nr)
    of, df = _foliage_rays(scene, nr)
    tb_ = torch.full((nr,), 1e30, device=dev)
    r = _measure(trace1, scene, ob, db, tb_,
                 f"K2 opaque tables ({scene['pk_blkbox'].shape[0]} blocks of "
                 f"{meta.block_k}) x {nr} bounce rays", ("closest", "any_hit"))
    kern["trace1[closest]"] = r["closest"]
    kern["trace1[any_hit]"] = r["any_hit"]
    alpha = _subset_scene(scene, "pka_")
    r = _measure(trace1, alpha, of, df, tb_,
                 f"K2 alpha tables ({alpha['pk_blkbox'].shape[0]} blocks of "
                 f"{meta.alpha_block_k}) x {nr} foliage rays",
                 ("amask1", "amask2"))
    kern["trace1[amask1]"] = r["amask1"]
    kern["trace1[amask2]"] = r["amask2"]
    del alpha, ob, db, of, df
    path_b, _ = _frame(filmmod, scene, cam, meta,
                       dataclasses.replace(cfg, max_depth=DEPTH_BD),
                       f"path B d{DEPTH_BD} (single-level kernel)",
                       "sanmiguel_small.ppm")
    _need(path_b, [f"trace1[{m}]" for m in ("closest", "any_hit", "amask1",
                                            "amask2")], "path B")

    del scene

    # ---- 8. path D: volpath on the scene's own analytic prims
    scene, cam, meta = spheres_medium(resolution=RES, device=dev)
    cfg_d = RenderConfig(spp=1, max_depth=DEPTH_BD, integrator="volpath",
                         rays_per_batch=65536, regenerate=True)
    path_d, _ = _frame(filmmod, scene, cam, meta, cfg_d,
                       f"path D volpath spheres_medium d{DEPTH_BD}",
                       "spheres_medium.ppm")
    del scene

    # ---- 8b. [cli]: the command line and what it reaches
    cli_counts = _cli_phase(render_image, filmmod)

    # ---- 8c. [oracle]: the independent NumPy oracle held to the port,
    # brute, through K2 and through K1; 8d. [example]: the walkthrough
    _oracle_phase()
    _example_phase(render_image)

    # ---- 9. K4, the leaf micro-benchmark, through its own entry point
    leaf_rows, leaf_counts = _leaf_phase()
    kern.update(leaf_rows)

    # ---- 10. summary
    # launches: of ONE full-width frame whose path runs the mode (the
    # faithful frame, else path A, else path B), or, for the modes that no
    # full-width scene of the package reaches, the sum over the five small
    # card renders (48x48, 4 spp, depth 3); launches_from says which
    frames = (("the faithful frame, 1080p depth 64", faithful),
              (f"the path C frame, 1080p depth {DEPTH_AC}", path_c),
              (f"the path A frame, 1080p depth {DEPTH_AC}", path_a),
              (f"the path B frame, 1080p depth {DEPTH_BD}", path_b),
              (f"the K4 run at its defaults (K2={LEAF_K2}, n_iter="
               f"{LEAF_ITERS}; warm-up, timed runs and the n_iter=0 "
               f"baseline)", leaf_counts))
    small_from = "the small card renders together (48x48; volpath mesh " \
        "renders 2 spp depth 4, the others 4 spp depth 3): no full-width " \
        "scene reaches this mode"
    replaces = {"trace2": "pathtracing_tpu/accel/pallas_trace2.py:438",
                "trace1": "pathtracing_tpu/accel/pallas_trace.py:289",
                "leaf": "tools/bench_mxu_leaf.py:63"}
    # rows of a schedule no entry point runs on those tables
    no_entry = {"trace2[pair]": (
        "none: no entry point passes pair=True (the reference package's "
        "dispatch does not either); timed and held to the window=1 walk "
        "only")}
    for a in (1, 2):
        no_entry[f"trace2[window2_amask{a}]"] = (
            "none: path C runs window 4 on the alpha passes, and PT_WINDOW=2 "
            "reaches only the volpath mesh render's closest passes; timed and "
            "held to the window=1 walk and the plain walk only")
    rows = []
    for name in sorted(kern):
        stem = name.split("[")[0]
        n_launch, where = next(((c[name], w) for w, c in frames
                                if c.get(name, 0) > 0),
                               (small_counts.get(name, 0), small_from))
        if n_launch <= 0 and name not in no_entry:
            raise RuntimeError(f"{name} was never launched by a render")
        if n_launch <= 0:
            where = no_entry[name]
        row = {"name": name, "route": "cuda",
               "source": f"pathtracing_tpu_torch/csrc/{stem}.cu",
               "replaces": replaces[stem],
               "launches": n_launch, "launches_from": where,
               "launches_faithful_path": faithful.get(name, 0),
               "launches_path_c": path_c.get(name, 0),
               "launches_small_renders": small_counts.get(name, 0),
               "launches_legacy_path": legacy.get(name, 0),
               "launches_path_a": path_a.get(name, 0),
               "launches_path_b": path_b.get(name, 0),
               "launches_path_d": path_d.get(name, 0),
               "launches_cli_frame": cli_counts.get(name, 0),
               "library_ms": None}
        row.update(kern[name])
        if row["library_ms"] is None and "library" not in row:
            row["library"] = ("none: no single PyTorch call traverses a "
                              "BVH")
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
