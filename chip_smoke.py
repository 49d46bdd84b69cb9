#!/usr/bin/env python3
"""Smoke run of pathtracing_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the JSON
device summary only when every phase passed):
  1. build the CUDA kernel (csrc/trace2.cu) with nvcc and print its time
     and each mode's registers;
  2. hold the trace2 kernel against its plain PyTorch version on the card,
     in all four modes, no flip allowed:
     a. closest hit and any-hit on a 200K-triangle soup with 64K rays,
        against the brute force over every table slot;
     b. the alpha micro-mask modes (amask 1 and 2) on a 200K-triangle
        soup of alpha-cutout cards (masks from the scene's leaf texture)
        with 65,280 rays, against the same brute force;
     c. closest hit and any-hit on the 10.5M-triangle San-Miguel-analog
        tables with 65,280 bounce-like rays (the render's dispatch width)
        against the plain version culled by child box, after checking
        that every child box holds its triangles; kernel and plain times
        and the kernel's bound from its counters;
     d. (after phase 5's scene build) amask 1 and 2 on the faithful
        scene's full alpha tables (240,000 foliage triangles) with 65,280
        rays through the foliage, the same way; the share of lanes mode 1
        culled and mode 2 resolved as `solid` must both be > 0;
  3. card numerics against the port's CPU numerics, which the CPU tests
     hold to the JAX package: small renders (the untextured and the
     faithful San-Miguel analog, the Cornell box, the textured quad) must
     agree on more than 99% of pixel values to rtol=1e-4, atol=1e-5 (the
     faithful miniature at depth 2: its normal map amplifies one-ulp
     differences, so its depth-4 agreement is printed, not held), and
     the shadow predicate on ~8K rays through a small faithful scene's
     foliage must be equal lane for lane (MASK mode is deterministic);
  4. the legacy path: sanmiguel_analog(faithful=False) at 1920x1080, path
     tracing, depth 32, 1 spp, regenerate=True, one frame through the
     public render(); launches > 0, image finite with a positive mean;
  5. the faithful path: sanmiguel_analog(faithful=True) (10.5M terrain +
     240,000 alpha foliage triangles, textures, normal map, glass, metal,
     lamp meshes) at 1920x1080, path tracing, depth 64, 1 spp,
     regenerate=True, a warm and a timed frame through render(); the
     kernel's launch counts over the timed frame must be > 0 in all four
     modes and the image finite with a positive mean; with --sections, one
     more frame with a timer around each section of the bounce loop; with
     --profile, one more frame under torch.profiler;
  6. print the kernel table JSON, the card's name and power limit, and the
     device summary.
Writes chiprun_out/sanmiguel_legacy.ppm and chiprun_out/sanmiguel_faithful.ppm.

The script imports nothing of JAX.  Tolerances: the kernel and the plain
version share the arithmetic (the kernel is built without FMA
contraction) and both break ties in t by the least table slot, and the
amask=2 contract does not depend on visit order, so `valid`, `tri` and
`solid` must agree exactly (no flip allowed) and `t` to rtol=1e-5.  In
any-hit mode `tri` is whichever occluder the traversal found first, so
only `valid` is compared, and every reported occluder is checked to be
hit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

RES = (1920, 1080)          # both paths: San-Miguel analog at 1080p,
N_TRIS = 10_500_000         # 10.5M-triangle terrain;
DEPTH = 32                  # the legacy path's depth,
DEPTH_FAITHFUL = 64         # the faithful path's
FOLIAGE = 2500              # shrub instances (96 alpha triangles each)
FP32_PEAK = 67e12           # H100 SXM fp32 (non-tensor) FLOP/s
HBM_RATE = 3.35e12          # H100 SXM HBM3 bytes/s
SLAB_FLOPS = 20             # one ray/box slab test
MT_FLOPS = 45               # one ray/triangle Moller-Trumbore test
MASK_FLOPS = 20             # one alpha-cell lookup (affine map, bit tests)
MASK_BYTES = 32             # mask words of one slot


def _sync_time(fn, reps=20):
    """ms per call of fn(): one warm call, then `reps` calls back to back
    on the current stream between two CUDA events."""
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


def _compare(trace2, scene, o, d, t_max, label, prune):
    """Kernel vs plain version (culled by child box, or the brute force
    over every slot); returns (max_abs_err of t, ms of the plain
    version's call)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = trace2.tri_intersect2_plain(scene, o, d, t_max, prune=prune)
    b.record()
    got = trace2.tri_intersect2(scene, o, d, t_max)
    anyh = trace2.tri_intersect2(scene, o, d, t_max, any_hit=True)
    torch.cuda.synchronize()
    n = o.shape[0]
    flips = int((got["valid"] != ref["valid"]).sum())
    both = got["valid"] & ref["valid"]
    tri_diff = int((both & (got["tri"] != ref["tri"])).sum())
    same = both & (got["tri"] == ref["tri"])
    t_bad = int((same & ~torch.isclose(got["t"], ref["t"], rtol=1e-5,
                                       atol=0.0)).sum())
    err = float((got["t"] - ref["t"]).abs()[same].max()) if same.any() \
        else 0.0
    any_flips = int((anyh["valid"] != ref["valid"]).sum())
    # every any-hit occluder must really be hit within t_max
    v = anyh["valid"]
    tv = scene["tri_v"] if "tri_v" in scene else None
    occl_bad = 0
    if tv is not None and v.any():
        idx = torch.nonzero(v)[:, 0]
        tri = tv[anyh["tri"][idx]]
        t = _ray_tri_t(o[idx], d[idx], tri)
        occl_bad = int((~((t >= 1e-5) & (t < t_max[idx]))).sum())
    plain_ms = a.elapsed_time(b)
    print(f"[compare] {label} vs {'culled' if prune else 'brute'} plain "
          f"({plain_ms:.1f} ms): rays={n} hits={int(ref['valid'].sum())} "
          f"closest: valid_flips={flips} tri_mismatch={tri_diff} "
          f"t_outside_rtol={t_bad} max_abs_err_t={err:.3e} | any-hit: "
          f"valid_flips={any_flips} bad_occluders={occl_bad}", flush=True)
    if flips or tri_diff or t_bad or any_flips or occl_bad:
        raise RuntimeError(f"kernel disagrees with its plain version on "
                           f"{label}")
    return err, plain_ms


def _compare_amask(trace2, scene, o, d, t_max, label, prune):
    """Kernel vs plain version in the alpha micro-mask modes.  Returns
    {mode: (max_abs_err of t, plain ms, share culled or solid)}."""
    import torch
    n = o.shape[0]
    base = trace2.tri_intersect2(scene, o, d, t_max)
    out = {}
    for amask in (1, 2):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = trace2.tri_intersect2_plain(scene, o, d, t_max, prune=prune,
                                          amask=amask)
        b.record()
        got = trace2.tri_intersect2(scene, o, d, t_max, amask=amask)
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        flips = int((got["valid"] != ref["valid"]).sum())
        tri_diff = int((got["tri"] != ref["tri"]).sum())
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
              f"tri_mismatch={tri_diff} t_outside_rtol={t_bad} "
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


def _bounce_rays(scene, n, seed=2):
    """Bounce-like rays: random off-surface origins in the lower part of
    the scene box, downward-hemisphere directions, sorted by first entered
    block as the dispatch sorts them."""
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
    perm = torch.argsort(_first_block_key(scene, o, d), stable=True)
    return o[perm].contiguous(), d[perm].contiguous()


def _bound_ms(trace2, scene, o, d, t_max, amask=0):
    """Least time for the work this run's rays need: the larger of the
    fp32 operations (slab and triangle tests the traversal performs and,
    in the alpha modes, its mask lookups, from the kernel's counters) over
    the fp32 peak, and the bytes over the HBM rate: rays in (28 B) and
    results out (8 B) once each, the L1 table (boxes + child base), once
    each the child boxes of the L1s and the triangle rows of the child
    blocks that some ray visited, and the 32 B of mask words of every hit
    that looked its cell up."""
    res = trace2.tri_intersect2(scene, o, d, t_max, counters=True,
                                amask=amask)
    cnt = res["counters"].to(float).sum(0)
    m1 = scene["pk_l1box"].shape[0]
    g = scene["pk_l2box"].shape[0] // m1
    k2 = scene["pk_tri"].shape[0] // scene["pk_l2box"].shape[0]
    flops = (float(cnt[0]) * m1 * SLAB_FLOPS + float(cnt[1]) * g * SLAB_FLOPS
             + float(cnt[2]) * k2 * MT_FLOPS + float(cnt[3]) * MASK_FLOPS)
    n = o.shape[0]
    l1_seen = int(res["l1_touched"].sum())
    leaf_seen = int(res["leaf_touched"].sum())
    nbytes = (n * (28 + 8) + m1 * 36 + l1_seen * g * 32
              + leaf_seen * k2 * 48 + float(cnt[3]) * MASK_BYTES)
    ops_ms, bytes_ms = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    per_ray = (cnt / n).tolist()
    print(f"[bound] amask={amask} rays={n} per-ray: L1 passes="
          f"{per_ray[0]:.2f} L1 visits={per_ray[1]:.2f} leaf blocks="
          f"{per_ray[2]:.2f} (tri tests={per_ray[2] * k2:.0f}) mask lookups="
          f"{per_ray[3]:.3f}; L1s visited {l1_seen}/{m1}, "
          f"child blocks visited {leaf_seen}/{m1 * g}; flops={flops:.3e} "
          f"bytes={nbytes:.3e} ops_ms={ops_ms:.4f} bytes_ms={bytes_ms:.4f}",
          flush=True)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _card_vs_cpu(render_image, scene, cam, meta, cfg, label, min_frac=0.99):
    """The same small render on the card (kernel, float32 GPU math) and
    on the CPU (plain traversal, the numerics the CPU tests hold to the
    JAX package); fails unless >99% of values agree to rtol=1e-4,
    atol=1e-5 (the JAX package's rule for two traversal paths)."""
    import torch
    got = render_image(scene, cam, meta, cfg, device="cuda").cpu()
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
    """Two-level tables, with micro-masks, of n_cards randomly oriented
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
    tabs, _ = trace2.build_tri_blocks2(tri_v, g=32, tri_mask=masks)
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


def _occluded_card_vs_cpu(scene, cam, meta, n=8160):
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
          f"the small faithful scene: occluded {int(want.sum())} (cpu) "
          f"{int(got.sum())} (card), lane flips {flips}, chain restarts "
          f"{stats['restarts']}", flush=True)
    if flips or not 0 < int(want.sum()) < n:
        raise RuntimeError("the card's shadow predicate disagrees with the "
                           "CPU's")


def _frame(trace2, render, filmmod, scene, cam, meta, cfg, label, ppm,
           warm):
    """Render one timed frame through render() (after a warm one if asked)
    with the kernel's launch counts set to 0 just before it and read just
    after; print its numbers, check the image, write it.  Returns the
    launch counts per mode."""
    import torch
    if warm:
        t0 = time.perf_counter()
        render(scene, cam, meta, cfg)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    stats = {}
    trace2.reset_launches()
    t0 = time.perf_counter()
    film = render(scene, cam, meta, cfg, stats=stats)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    by_mode = dict(trace2.tri_intersect2.launches_by_mode)
    total = trace2.tri_intersect2.launches
    w, h = cam["resolution"]
    img = filmmod.finalize(film)
    mean = float(img.mean())
    finite = bool(torch.isfinite(img).all())
    calls = stats.get("occluded_calls", 0)
    restarts = stats.get("chain_restarts", 0) / calls if calls else 0.0
    warm_txt = f"{warm_s:.2f}s" if warm else "none"
    print(f"[render] {label}: {w}x{h} 1spp regen: warm {warm_txt} timed "
          f"{frame_s:.2f}s camera_samples/s {w * h / frame_s:.1f} "
          f"rays/sample {stats['n_rays'] / (w * h):.3f} trace2 launches "
          f"{total} by mode {by_mode} occluded calls {calls} chain restarts/"
          f"call {restarts:.3f} image mean {mean:.5f} finite {finite}",
          flush=True)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    filmmod.write_ppm(film, (w, h), out_dir / ppm)
    if total != sum(by_mode.values()):
        raise RuntimeError("per-mode launch counts do not add up")
    if not finite or not mean > 0.0:
        raise RuntimeError(f"bad image: mean={mean} finite={finite}")
    return by_mode


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

    def kernel_name(scene, o, d, t_max, any_hit, counters, amask):
        return "  > K1 kernel " + T._mode_name(any_hit, amask)

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
                    "bounce loop, and print each section's share")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pathtracing_tpu_torch import RenderConfig, SamplerConfig, render, \
        render_image
    from pathtracing_tpu_torch.accel import trace2
    from pathtracing_tpu_torch.native.loader import native_available
    from pathtracing_tpu_torch.scene import builder
    from pathtracing_tpu_torch.scene.intersect import _subset_scene
    from pathtracing_tpu_torch.scenes import (cornell_box, sanmiguel_analog,
                                              textured_quad)
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

    # ---- 1. build
    t0 = time.perf_counter()
    trace2.build_kernel()
    print(f"[build] trace2.cu built+loaded in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for line in trace2.BUILD_LOG.splitlines():
        if "Compiling entry" in line:
            mode = line.split("trace2_kernelILi")[1][0]
            print(f"[build] kernel instance AMASK={mode}:", flush=True)
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # ---- 2a. random soup, closest + any-hit
    rng = np.random.default_rng(13)
    nt = 200_000
    v0 = rng.uniform(-60, 60, (nt, 3)).astype(np.float32)
    tri_v = np.stack([v0, v0 + rng.normal(0, 1.5, (nt, 3)),
                      v0 + rng.normal(0, 1.5, (nt, 3))], 1).astype(np.float32)
    tabs, _ = trace2.build_tri_blocks2(tri_v, g=32)
    soup = {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}
    soup["tri_v"] = torch.from_numpy(tri_v).to(dev)
    n = 65536
    o, d = _shell_rays(rng, n, dev)
    _compare(trace2, soup, o, d, torch.full((n,), 3e38, device=dev),
             "soup 200K tris x 64K rays", prune=False)
    del soup

    # ---- 2b. alpha-card soup, amask 1 + 2 against the brute force
    nr = (65536 // RES[0]) * RES[0]          # 34 rows x 1920 = 65,280 lanes
    cards = _card_soup(np.random.default_rng(17), 100_000, dev, trace2)
    o, d = _shell_rays(rng, nr, dev)
    _compare_amask(trace2, cards, o, d, torch.full((nr,), 3e38, device=dev),
                   "card soup 200K tris", prune=False)
    del cards

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
    kern = {}
    err, plain_ms = _compare(trace2, scene, o64, d64, t64,
                             f"{meta.n_tri:,}-tri tables x {nr} bounce rays",
                             prune=True)
    ms = _sync_time(lambda: trace2.tri_intersect2(scene, o64, d64, t64))
    ms_any = _sync_time(lambda: trace2.tri_intersect2(scene, o64, d64, t64,
                                                      any_hit=True))
    bound_ms, bound_by = _bound_ms(trace2, scene, o64, d64, t64)
    print(f"[kernel] {nr}-ray bounce dispatch: closest {ms:.3f} ms, any-hit "
          f"{ms_any:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by})", flush=True)
    for mode, t_ms in (("closest", ms), ("any_hit", ms_any)):
        kern[mode] = dict(max_abs_err=err, ms=t_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    del o64, d64

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
    del mini

    # ---- 4. the legacy path, through the public entry point
    # as bench.py renders the legacy cell: default 4x4 stratified sampler
    cfg = RenderConfig(spp=1, max_depth=DEPTH, integrator="path",
                       rays_per_batch=65536, regenerate=True)
    legacy = _frame(trace2, render, filmmod, scene, cam, meta, cfg,
                    f"legacy path d{DEPTH}", "sanmiguel_legacy.ppm",
                    warm=False)
    if legacy["closest"] <= 0 or legacy["any_hit"] <= 0:
        raise RuntimeError("the legacy render never launched the kernel")
    del scene

    # ---- 5. the faithful path
    t0 = time.perf_counter()
    scene, cam, meta = sanmiguel_analog(resolution=RES, n_tris=N_TRIS,
                                        foliage=FOLIAGE, faithful=True,
                                        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bs = builder.BUILD_SECONDS
    alpha = _subset_scene(scene, "pka_")
    n_alpha = int((scene["pka_slot2tri"] >= 0).sum())
    print(f"[scene] sanmiguel_analog(faithful=True): {meta.n_tri:,} tris "
          f"({n_alpha:,} alpha) + {meta.n_sph} spheres + {meta.n_quad} quads, "
          f"{meta.n_lights} lights, accel={meta.accel}; opaque tables K2="
          f"{meta.block_k} L1={scene['pk_l1box'].shape[0]}, alpha tables K2="
          f"{meta.alpha_block_k} G={meta.block_g} child blocks="
          f"{scene['pka_l2box'].shape[0]} L1={scene['pka_l1box'].shape[0]}, "
          f"alpha_cull_mask={meta.alpha_cull_mask}; build {build_s:.1f}s "
          f"(mask build {bs['masks']:.2f}s, tables {bs['tables']:.1f}s, "
          f"scene arrays + upload {build_s - bs['masks'] - bs['tables']:.1f}s)",
          flush=True)
    if n_alpha != FOLIAGE * 96 or not meta.alpha_cull_mask:
        raise RuntimeError("the faithful scene has no masked alpha tables")

    # ---- 2d. amask 1 + 2 on the full alpha tables
    if not trace2.child_boxes_hold_triangles(alpha, scene["tri_v"]):
        raise RuntimeError("an alpha child box does not hold its triangles")
    of, df = _foliage_rays(scene, nr)
    tf_ = torch.full((nr,), 1e30, device=dev)
    cmp_a = _compare_amask(trace2, alpha, of, df, tf_,
                           f"{n_alpha:,}-tri alpha tables x {nr} foliage rays",
                           prune=True)
    for amask in (1, 2):
        err_a, plain_a, share = cmp_a[amask]
        if not share > 0.0:
            raise RuntimeError(f"amask={amask} resolved no lane on the full "
                               f"alpha tables")
        ms_a = _sync_time(lambda: trace2.tri_intersect2(alpha, of, df, tf_,
                                                        amask=amask))
        b_ms, b_by = _bound_ms(trace2, alpha, of, df, tf_, amask=amask)
        print(f"[kernel] {nr}-ray foliage dispatch amask={amask}: {ms_a:.3f} "
              f"ms, plain {plain_a:.1f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        kern[f"amask{amask}"] = dict(max_abs_err=err_a, ms=ms_a,
                                     plain_ms=plain_a, bound_ms=b_ms,
                                     bound_by=b_by)
    del of, df, alpha

    cfg = RenderConfig(spp=1, max_depth=DEPTH_FAITHFUL, integrator="path",
                       rays_per_batch=65536, regenerate=True)
    faithful = _frame(trace2, render, filmmod, scene, cam, meta, cfg,
                      f"faithful path d{DEPTH_FAITHFUL}",
                      "sanmiguel_faithful.ppm", warm=True)
    for mode in ("closest", "any_hit", "amask1", "amask2"):
        if faithful[mode] <= 0:
            raise RuntimeError(f"the faithful render never launched the "
                               f"kernel in mode {mode}")

    if args.sections:
        _sections_frame(render, scene, cam, meta, cfg)
    if args.profile:
        _profile_frame(render, scene, cam, meta, cfg)

    # ---- 6. summary
    print(json.dumps({"kernels": [{
        "name": f"trace2[{mode}]",
        "route": "cuda",
        "source": "pathtracing_tpu_torch/csrc/trace2.cu",
        "replaces": "pathtracing_tpu/accel/pallas_trace2.py:438",
        "launches": faithful[mode],
        "launches_legacy_path": legacy[mode],
        **kern[mode],
        "library_ms": None} for mode in ("closest", "any_hit", "amask1",
                                         "amask2")]}))
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
