"""CPU tests of the harness's arithmetic and its data-driven lookup."""
from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from rtbench import registry, workload
from rtbench.devtrace import union_seconds, gaps, DeviceTrace
from rtbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_rate_over_whole_items_with_a_stall(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(workload.time, "perf_counter", clock)
    costs = [2.0, 2.0, 7.0, 2.0]          # the third item stalls

    def run_one(i):
        clock.t += costs[i]
        return 1000
    n, samples, elapsed, ends = workload.window(run_one, 10.0)
    # an item starts while one more, at the mean time so far, ends
    # within 10 s: at 0, 2 and 4 s (4 + 2 <= 10); at 11 s it stops
    assert n == 3 and samples == 3000
    assert ends == [2.0, 4.0, 11.0]
    # the stall counts in full: the rate runs to the end of the last item
    assert workload.rate(samples, elapsed) == pytest.approx(3000 / 11.0)
    with pytest.raises(ValueError):
        workload.rate(0, 0.0)


def test_items_cover_the_frame_once_per_frame():
    t = dict(registry.traffic("fwd-d64"))
    wl = workload.Workload(t, (1920, 1080), 2 ** 31 + 12345, "cpu")
    assert wl.n_tiles == 1080 and wl.per_frame == 8
    seen = []
    for i in range(8):
        it = wl.item(i)
        assert it.sample_index == wl.first_sample
        seen.append(it.pixel_idx)
        assert it.samples == it.pixel_idx.shape[0] == 135 * 1920
    import torch
    allpix = torch.sort(torch.cat(seen)).values
    assert torch.equal(allpix, torch.arange(1920 * 1080))
    assert wl.item(8).sample_index == wl.first_sample + 1
    # item k takes every 8th row from row k, in bit-reversed order of k
    assert [wl.item(i).k for i in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]
    assert wl.tiles(4) == list(range(4, 1080, 8))
    # coarse tiles: the first four items take every other tile over the
    # whole height
    coarse = workload.Workload(dict(t, rows_per_tile=34, tiles_per_item=4),
                               (1920, 1080), 5, "cpu")
    tiles = sorted(x for i in range(4) for x in coarse.tiles(coarse.item(i).k))
    assert tiles == list(range(0, 32, 2))
    # the same items for every seed, other sample indices and lanes
    wl2 = workload.Workload(t, (1920, 1080), 7, "cpu")
    assert torch.equal(wl2.item(3).pixel_idx, wl.item(3).pixel_idx)
    assert wl2.check_lanes().shape == wl.check_lanes().shape


def test_idle_share_from_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (9.0, 10.0)]
    assert union_seconds(iv) == pytest.approx(5.0)
    assert gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    tr = DeviceTrace()
    tr.dev_names = ["k1"] * len(iv)
    tr.dev = np.asarray(iv) * 1e6
    tr.host_names = ["aten::item", "sync", "Activity Buffer Request"]
    tr.host = np.asarray([(2.5, 9.5), (6.5, 8.5), (3.5, 4.5)]) * 1e6
    tr.window_s = 10.0
    assert tr.busy_s() == pytest.approx(5.0)
    assert 100 * (1 - tr.busy_s() / tr.window_s) == pytest.approx(50.0)
    # the gap under the profiler's own record is left out
    assert tr.idle_gaps() == [["sync", pytest.approx(3.0)]]
    assert tr.seconds_matching("k1") == pytest.approx(6.3)
    assert tr.seconds_matching("k2") is None


def _write(path: Path, text: str):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_new_pieces_are_found_by_name_without_edits(tmp_path):
    """A configuration, a mix, a metric and a cell are added as files and
    entries only: the harness's code is unchanged and finds them."""
    here = tmp_path / "rtbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    conf = json.loads((here / "configs" / "sanmiguel-legacy.json")
                      .read_text())
    conf.update(name="courtyard", params=dict(conf["params"], n_tris=60000,
                                              foliage=600, faithful=True))
    _write(here / "configs" / "courtyard.json", json.dumps(conf))
    mix = json.loads((here / "traffic" / "fwd-d64.json").read_text())
    mix.update(name="fwd-d8", max_depth=8)
    _write(here / "traffic" / "fwd-d8.json", json.dumps(mix))
    _write(here / "metrics" / "k2.roofline_share.py",
           "def read(ctx):\n    return ctx.get('k2')\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="courtyard",
                                 file="rtbench/configs/courtyard.json"))
    bench["workloads"].append(dict(name="courtyard-fwd-d8",
                                   config="courtyard", traffic="fwd-d8",
                                   chips=1, why="a new cell"))
    bench["per_layer"].append(dict(name="k2.roofline_share", unit="%",
                                   better="higher", source="device_trace",
                                   layer="traversal kernel K2",
                                   moves="fwd_samples_per_s",
                                   workloads=["courtyard-fwd-d8"]))
    bench["end_to_end"][0]["workloads"].append("courtyard-fwd-d8")
    cell = registry.cell(bench, "courtyard-fwd-d8")
    assert registry.config(cell["config"], here)["params"]["n_tris"] == 60000
    assert registry.traffic(cell["traffic"], here)["max_depth"] == 8
    assert registry.metric_reader("k2.roofline_share", here)(
        {"k2": 12.5}) == 12.5
    names = [m["name"] for m in registry.metrics_of(
        bench, "courtyard-fwd-d8", trace=True)]
    assert names == ["k2.roofline_share"]
    assert [m["name"] for m in registry.metrics_of(
        bench, "courtyard-fwd-d8", trace=False)] == ["fwd_samples_per_s",
                                                     "setup_s"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_benchmark_metrics_have_readers_and_cells():
    bench = registry.benchmark(ROOT)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
        assert set(m["workloads"]) <= cells
    for w in bench["workloads"]:
        registry.config(w["config"])
        registry.traffic(w["traffic"])
        assert registry.metrics_of(bench, w["name"], trace=True)
        e2e = [m["name"] for m in registry.metrics_of(bench, w["name"],
                                                      trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ((node.module,) if node.module
                                       else ()))
            else:
                yield node.module


def test_no_jax_and_a_reference_free_of_the_program():
    forbidden = {"jax", "jaxlib", "flax", "pathtracing_tpu"}
    files = [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in forbidden, (p, mod)
            if "reference" in p.relative_to(HERE).parts:
                assert mod.split(".")[0] != "pathtracing_tpu_torch", (p, mod)
        text = p.read_text()
        if p.name != Path(__file__).name:
            assert "BENCH_r0" not in text and "MULTICHIP_r0" not in text


def test_forbidden_modules_compares_whole_names():
    mods = {"pathtracing_tpu_torch": 1, "pathtracing_tpu_torch.scene": 1,
            "jaxtyping": 1, "torch": 1}
    assert forbidden_modules(mods) == []
    mods.update({"pathtracing_tpu.scene": 1, "jax.numpy": 1})
    assert forbidden_modules(mods) == ["jax.numpy", "pathtracing_tpu.scene"]
    assert not any(m.split(".")[0] == "pathtracing_tpu"
                   for m in forbidden_modules(sys.modules)
                   if m.startswith("pathtracing_tpu_torch"))
