"""Run one cell of BENCHMARK.json once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m rtbench.run ...` from the repository's root).  Set-up
imports the port, builds the cell's scene on the card from its frozen
description, loads the kernels and runs one warm-up item; then the window
runs whole work items of the cell's traffic for `--seconds`.  With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics: the window as measured, then its first
item run again under synced spans and again under torch.profiler
(README.md).  After the window the reference judges
what the timed path produced (rtbench/reference/check.py); every number
compared is printed beside its limit, last on standard error and under
"checks" at the end of the result line.  The run needs a CUDA card and
exits 2 without one; it never falls back to the CPU.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cache of the run stays inside the checkout, at fixed paths (the
# port's own kernel builds go to pathtracing_tpu_torch/_build/)
CACHE = ROOT / ".rtbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracing_tpu")
# a differentiable mix's checked step is one of the window's first items
PICK_SPAN = 3


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN (names
    compared whole: pathtracing_tpu_torch is not pathtracing_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def _free_program(scene):
    """Drop the program's scene tables before the reference builds its
    own (a process's peak memory never falls again)."""
    import gc
    import torch
    scene.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _power_limit():
    """The card's power limit as nvidia-smi reads it (None without it)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(cell_name, seed, seconds, trace=False, device="cuda",
             params=None, traffic_over=None, control=None, bench=None):
    """Run a cell once; returns the result dict.  `params` / `traffic_over`
    override the configuration's and the mix's values (the CPU tests run
    a tiny scene); `control` ("bf16") puts the reference computed in
    bfloat16 in the program's place: its numbers are judged, and decide
    `correct`, as the program's would."""
    import torch
    from rtbench import registry
    from rtbench.scenedesc import load_generator, replay
    from rtbench.workload import Workload, window, rate
    from rtbench.capture import Capture
    from rtbench.spans import Spans
    from rtbench.devtrace import DeviceTrace
    from rtbench.roofline import K1Probe
    from rtbench.reference.check import run_checks, LIMITS

    bench = bench or registry.benchmark(ROOT)
    cell = registry.cell(bench, cell_name)
    conf = registry.config(cell["config"])
    traffic = dict(registry.traffic(cell["traffic"]), **(traffic_over or {}))
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- set-up: the program, the scene, the kernels, one warm item
    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    from pathtracing_tpu_torch.integrators import render as program
    from pathtracing_tpu_torch.integrators.path import RenderConfig
    from pathtracing_tpu_torch.core.rng import SamplerConfig
    from pathtracing_tpu_torch.sensor.film import new_film

    gen_params = dict(conf["params"], **(params or {}))
    split = {"import_s": time.perf_counter() - T0}
    t = time.perf_counter()
    desc = load_generator(ROOT, conf["generator"])(**gen_params)
    split["describe_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scene, cam, meta = replay(desc, SceneBuilder()).build(
        **desc.build_kwargs, device=device)
    sync()
    split["build_s"] = time.perf_counter() - t
    seed32 = int(seed) & 0xFFFFFFFF
    sp = traffic["sampler"]
    cfg = RenderConfig(spp=1, max_depth=int(traffic["max_depth"]),
                       integrator=traffic["integrator"],
                       sampler=SamplerConfig(kind=sp["kind"],
                                             x_samples=sp["x_samples"],
                                             y_samples=sp["y_samples"],
                                             seed=seed32),
                       rr_start=int(traffic["rr_start"]),
                       rays_per_batch=int(traffic["lanes"]),
                       differentiable=bool(traffic.get("differentiable")),
                       regenerate=True)
    wl = Workload(traffic, cam["resolution"], seed, device)
    lanes = int(traffic["lanes"])
    w, h = cam["resolution"]
    names = list(traffic.get("params", ()))
    target = None
    if cfg.differentiable:
        # an inverse-rendering step's inputs: the parameter arrays it fits
        # and a target image made from the seed
        for k in names:
            scene[k].requires_grad_(True)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        target = torch.rand((w * h, 3), generator=gen, device=device) \
            * float(traffic["target_scale"])

    def drain(film, item, stats=None, marks=None):
        """One work item: a queue drain into `film`; for a differentiable
        mix also the loss over the item's pixels and its backward pass
        (no parameter update: every item renders the same scene)."""
        film = program.render_tile_regen(scene, cam, meta, cfg, film,
                                         item.pixel_idx, 1,
                                         item.sample_index, lanes=lanes,
                                         stats=stats)
        if not cfg.differentiable:
            return film, None
        pix = item.pixel_idx
        loss = ((film["rgb"][pix] - target[pix]) ** 2).mean()
        for k in names:
            scene[k].grad = None
        if marks is not None:
            sync()
            t = time.perf_counter()
        loss.backward()
        if marks is not None:
            sync()
            marks["backward_s"] = marks.get("backward_s", 0.0) \
                + time.perf_counter() - t
        return {k: v.detach() for k, v in film.items()}, dict(
            loss=float(loss.detach()) if not cuda else loss.detach(),
            grads={k: scene[k].grad for k in names})

    t = time.perf_counter()
    drain(new_film(cam["resolution"], device=device), wl.warm_item())
    sync()
    split["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    # a differentiable mix's check follows one step, drawn from the seed
    # before the window among the first PICK_SPAN items (the window runs
    # at least that many): only that step's records, film and gradients
    # are kept
    pick = None
    if cfg.differentiable:
        pick = int(torch.randint(PICK_SPAN, (1,), generator=torch.Generator(
        ).manual_seed(int(seed))))
    cap = Capture(wl.check_lanes(), cfg.max_depth, keep_drain=pick).install()
    stats = {}
    marks = {}
    # a forward mix splats every item into one film; a differentiable one
    # gives each item (each step) a film of its own
    films = [(new_film(cam["resolution"], device=device), [])]
    steps = {}

    def run_one(i):
        item = wl.item(i)
        cap.item = i
        if cfg.differentiable:
            film = new_film(cam["resolution"], device=device)
        else:
            film = films[0][0]
        t = time.perf_counter()
        # the traced run times the backward passes of its window (synced
        # marks: the drain's own host syncs precede them)
        film, step = drain(film, item, stats, marks if trace else None)
        if i == 0:
            sync()
            marks["plain_item_s"] = time.perf_counter() - t
        if not cfg.differentiable:
            films[0] = (film, films[0][1] + [i])
        elif i == pick:
            films[0] = (film, [i])
            steps[i] = step
        return item.samples

    try:
        n_items, samples, elapsed, ends = window(
            run_one, seconds, sync=sync,
            at_least=pick + 1 if pick is not None else 1)
    finally:
        cap.remove()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(peak_setup, peak_window)

    # ---- the traced run's probes, after the window: the window's first
    # item run again, the same work, once under synced spans (with K1's
    # first closest dispatches kept for its roofline) and once under the
    # profiler; neither is timed as part of the window
    dtrace = spans = k1 = None
    if trace:
        dtrace, spans = DeviceTrace(), Spans()
        # K1's roofline (two-level tables only; the kernel runs only on a
        # card)
        probe = K1Probe(scene["pk_tri"]).install() \
            if cuda and "pk_l1box" in scene else None
        item = wl.item(0)
        spans.install()
        if probe is not None:
            probe.armed = True
        try:
            t = time.perf_counter()
            drain(new_film(cam["resolution"], device=device), item)
            sync()
            marks["span_s"] = time.perf_counter() - t
        finally:
            spans.remove()
            if probe is not None:
                probe.remove()
        dtrace.run(lambda: drain(new_film(cam["resolution"], device=device),
                                 item))
        k1 = probe.measure() if probe is not None else None
        if k1 is not None:
            k1["power_limit"] = _power_limit()
    films = [({k: v.detach() for k, v in f.items()}, idx)
             for f, idx in films if idx]
    failed = sum(int((~torch.isfinite(out)).any(-1).sum())
                 for _, out, _, _, _ in cap.items)
    grad = None
    if pick is not None:
        grad = dict(item=pick, loss=float(steps[pick]["loss"]),
                    grads=steps[pick]["grads"], target=target, names=names)
        steps.clear()

    ctx = dict(stats=stats, samples=samples, items=n_items,
               elapsed=elapsed, ends=ends, seconds=seconds,
               peak_window_bytes=peak_window, trace=dtrace, spans=spans,
               span_window_s=marks.get("span_s"),
               backward_s=marks.get("backward_s"), k1_roofline=k1,
               plain_item_s=marks.get("plain_item_s"),
               traffic=traffic, meta=meta)
    metrics = {}
    for m in registry.metrics_of(bench, cell_name, trace):
        if not trace and m["name"] == "setup_s":
            val = setup_s
        elif not trace:
            val = rate(samples, elapsed)
        else:
            val = registry.metric_reader(m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}

    # ---- the check, with the program's scene freed first
    _free_program(scene)
    del scene
    t = time.perf_counter()
    # with `control` the control's numbers stand where the program's
    # would, and go through the same limits
    checks = run_checks(desc, traffic, seed32, cap, films, device,
                        control=control, grad=grad)
    split["check_s"] = time.perf_counter() - t
    compared = {k: {"value": v, "limit": LIMITS[k]}
                for k, v in checks.items() if k in LIMITS}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=int(samples),
                  failed=int(failed), metrics=metrics, device=dev)
    if trace and dtrace is not None and cuda:
        dev.update(busy_s=dtrace.busy_s(), window_s=dtrace.window_s)
        result["breakdown"] = dict(device_ops=dtrace.top_ops(),
                                   idle_gaps=dtrace.idle_gaps())
    result["info"] = dict(items=n_items, item_ends_s=ends, times=split,
                          k1_roofline=k1,
                          bounces_checked=checks.get("bounces_checked"),
                          shadow_rays_checked=checks.get(
                              "shadow_rays_checked"),
                          instanced_hits_checked=checks.get(
                              "instanced_hits_checked"),
                          drains_kept=sorted(cap.drains),
                          stats={k: int(v) for k, v in stats.items()})
    if control is not None:
        result["info"]["control"] = control
    result["checks"] = compared
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="judge the reference computed in bfloat16 in the "
                    "program's place (the limits' control, which reads "
                    "correct false; never a measured run)")
    args = ap.parse_args(argv)

    from rtbench import registry
    bench = registry.benchmark(ROOT)
    chips = registry.cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      trace=bool(args.trace), bench=bench,
                      control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
