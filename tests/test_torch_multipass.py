"""K1's visit cap, frontier outputs and schedules (accel/trace2.py), the
multipass driver (scene/intersect.py::_multipass2) and the environment
switches the port reads at the JAX package's points, each against the JAX
package."""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.accel.pallas_trace2 import (build_tri_blocks2 as j_build,
                                                 pallas_tri_intersect2)
from pathtracing_tpu.core.math import BIG_F32
from pathtracing_tpu.scene import intersect as jisect
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.accel import cubuild, trace2
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import intersect as tisect
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _soup(rng, n_tri):
    v0 = rng.uniform(-6, 6, (n_tri, 3)).astype(np.float32)
    return np.stack([v0,
                     v0 + rng.normal(0, .4, (n_tri, 3)).astype(np.float32),
                     v0 + rng.normal(0, .4, (n_tri, 3)).astype(np.float32)],
                    1)


def _bvh_rays(rng, n=256, spread=6.0):
    """The rays of the JAX package's test_multipass_matches_single_pass."""
    o = rng.uniform(-2 * spread, 2 * spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _tabs(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def bvh_soup():
    """The JAX package's multipass test case (tests/test_bvh.py:404-438):
    4,000 triangles, k2=128, g=4 (many small L1s), 256 rays, every 7th
    dead."""
    tri_v = _soup(np.random.default_rng(21), 4000)
    ja, k2 = j_build(tri_v, k2=128, g=4)
    ta, tk2 = trace2.build_tri_blocks2(tri_v, k2=128, g=4)
    assert tk2 == k2
    o, d = _bvh_rays(np.random.default_rng(22))
    t_max = np.full((256,), BIG_F32, np.float32)
    t_max[::7] = 0.0
    return tri_v, ja, k2, _tabs(ta), o, d, t_max


@pytest.mark.parametrize("any_hit", [False, True])
def test_torch_multipass_matches_jax(bvh_soup, any_hit):
    """The port's _multipass2 (per-ray caps on the plain capped walk)
    against the JAX package's (per-tile caps in the Pallas kernel) with
    visits=(2, 1, 2): the capped passes' frontiers differ, the final
    result does not (valid and tri exact, t to rtol 1e-6)."""
    _, ja, k2, tabs, o, d, t_max = bvh_soup
    jscene = {k: jnp.asarray(v) for k, v in ja.items()}
    want = jisect._multipass2(jscene, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), k2, any_hit, None,
                              visits=(2, 1, 2), g=4)
    got = tisect._multipass2(tabs, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t_max), any_hit, None,
                             (2, 1, 2))
    v = np.asarray(want["valid"])
    assert 20 < v.sum() < 256
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    if not any_hit:
        np.testing.assert_array_equal(got["tri"].numpy()[v],
                                      np.asarray(want["tri"])[v])
        np.testing.assert_allclose(got["t"].numpy()[v],
                                   np.asarray(want["t"])[v], rtol=1e-6)
    # and the single uncapped pass of both packages agrees with it
    one = pallas_tri_intersect2(jscene, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), k2, g=4, any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(one["valid"]), v)


@pytest.mark.parametrize("cap", [1, 2, 5])
def test_torch_capped_frontier_is_sound(bvh_soup, cap):
    """The plain capped walk's frontier against brute force: every ray's
    true nearest hit is either found by the capped walk or lies in an L1
    that the walk did not consume, whose entry is >= e_next (the frontier
    is the nearest unconsumed L1 that can still beat the bound); a ray
    reported resolved (e_next = BIG_F32) has found its nearest hit."""
    _, _, _, tabs, o, d, t_max = bvh_soup
    o, d, tm = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    brute = trace2.tri_intersect2_plain(tabs, o, d, tm, prune=False)
    cap_r = trace2.tri_intersect2_plain(tabs, o, d, tm, max_visits=cap,
                                        frontier=True)
    found = ~brute["valid"] | (cap_r["valid"] & (cap_r["t"] == brute["t"]))
    missed = ~found
    assert missed.any() and found.any()
    # the L1 of each missed nearest hit, and that L1's kernel entry
    slot = torch.nonzero(tabs["pk_slot2tri"][None, :]
                         == brute["tri"][missed][:, None])[:, 1]
    per_l1 = tabs["pk_slot2tri"].shape[0] // tabs["pk_l1_base"].shape[0]
    l1 = slot // per_l1
    inv = tisect._inv_guard(d[missed])
    e = trace2.slab_entries(tabs["pk_l1box"], o[missed], inv, tm[missed])
    e_l1 = e[torch.arange(l1.shape[0]), l1]
    assert (cap_r["e_next"][missed] < BIG_F32).all()
    assert (e_l1 >= cap_r["e_next"][missed]).all()
    resolved = cap_r["e_next"] >= BIG_F32
    assert found[resolved].all()
    # without a cap the walk resolves every ray
    full = trace2.tri_intersect2_plain(tabs, o, d, tm, frontier=True)
    assert (full["e_next"] >= BIG_F32).all() and (full["b_next"] == 0).all()


def test_torch_schedule_refusals(bvh_soup):
    """The combinations the reference kernel asserts against are refused,
    by the wrapper and by the kernel's C entry."""
    _, _, _, tabs, o, d, t_max = bvh_soup
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    bad = (dict(pair=True, max_visits=2), dict(pair=True, frontier=True),
           dict(window=2, pair=True), dict(window=4, max_visits=2),
           dict(window=2, frontier=True), dict(window=3),
           dict(max_visits=0), dict(pops=0),
           dict(frontier=True, recull_every=1 << 29))
    for kw in bad:
        for fn in (trace2.tri_intersect2, trace2.tri_intersect2_plain):
            with pytest.raises(ValueError):
                fn(tabs, o, d, BIG_F32, **kw)
    # recull_every / drain_cull select nothing
    a = trace2.tri_intersect2(tabs, o, d, BIG_F32, recull_every=1,
                              drain_cull=False)
    b = trace2.tri_intersect2(tabs, o, d, BIG_F32)
    for k in ("t", "tri", "valid"):
        assert torch.equal(a[k], b[k])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/trace2.cu compiled as plain C++ (one loop iteration per CUDA
    thread): the kernel's walk where there is no card and no nvcc."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    return trace2.bind(cubuild.host_library(
        "trace2", tmp_path_factory.mktemp("trace2_mp")))


def _inst_tables(rng, motion):
    """Small instanced tables (30 sheared instances of two models over
    world triangles), with velocities when `motion`."""
    ov = np.concatenate([_soup(rng, 60) * np.float32(0.3),
                         _soup(rng, 90) * np.float32(0.3)])
    fw, iv = [], []
    for _ in range(30):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rng.normal(0, 0.6, (3, 3)) + np.eye(3) * 1.2
        m[:3, 3] = rng.uniform(-5, 5, 3)
        fw.append(m[:3, :4])
        iv.append(np.linalg.inv(m)[:3, :4].astype(np.float32))
    args = (_soup(rng, 800), ov, fw, iv, [0] * 15 + [60] * 15,
            [60] * 15 + [90] * 15)
    kw = {}
    if motion:
        kw = dict(tri_vel=rng.normal(0, 1, (800, 3)).astype(np.float32),
                  inst_vel=rng.normal(0, 1, (30, 3)).astype(np.float32),
                  shutter=(0.0, 1.0))
    return trace2.build_tri_blocks2_inst(*args, k2=32, g=4, **kw)[0]


@pytest.mark.parametrize("kind", ["plain", "instanced", "motion",
                                  "instanced_motion"])
def test_torch_trace2_kernel_source_new_modes(host_lib, kind):
    """The CUDA kernel's new modes (compiled as host C++) against the
    plain version: caps 1 / 2 / 16 with frontier outputs against the plain
    capped walk (t, slot, e_next, b_next; any-hit: the occlusion flag),
    and windows 2 / 4 (pops = 2 * window), pair and pops 1 / 4 against the
    window=1, pops=1 walk: 0 flips, t bit-equal."""
    rng = np.random.default_rng(41)
    time = None
    if kind == "plain":
        tabs = _tabs(trace2.build_tri_blocks2(_soup(rng, 3000), k2=64,
                                              g=8)[0])
    elif kind == "motion":
        tv = _soup(rng, 3000)
        tabs = _tabs(trace2.build_tri_blocks2(
            tv, k2=64, g=8, tri_vel=rng.normal(0, 1, (3000, 3)).astype(
                np.float32), shutter=(0.0, 1.0))[0])
    else:
        tabs = _tabs(_inst_tables(rng, kind == "instanced_motion"))
    o, d = _bvh_rays(np.random.default_rng(42), 300)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tm = torch.full((300,), BIG_F32)
    tm[::5] = 9.0
    tm[::11] = 0.0
    if kind in ("motion", "instanced_motion"):
        time = torch.from_numpy(rng.uniform(0, 1, 300).astype(np.float32))

    def kern(any_hit, **kw):
        return trace2._launch_kernel(tabs, o, d, tm, any_hit, False, 0, time,
                                     host_lib=host_lib, **kw)

    for any_hit in (False, True):
        bt, bk, _ = kern(any_hit)
        assert (bk >= 0).sum() > 10
        for cap in (1, 2, 16):
            t, k, ex = kern(any_hit, max_visits=cap, frontier=True)
            pt, pk, pe, pb = trace2._plain_capped(tabs, o, d, tm, cap, 0,
                                                  time, any_hit)
            if any_hit:
                assert torch.equal(k >= 0, pk >= 0), cap
            else:
                assert torch.equal(t, pt) and torch.equal(k, pk), cap
            assert torch.equal(ex["e_next"], pe), cap
            assert torch.equal(ex["b_next"], pb), cap
            if cap == 1:
                assert (pe < BIG_F32).sum() > 10
        for kw in (dict(window=2, pops=4), dict(window=4, pops=8),
                   dict(pair=True), dict(pops=1), dict(pops=4)):
            t, k, _ = kern(any_hit, **kw)
            if any_hit:
                assert torch.equal(k >= 0, bk >= 0), kw
            else:
                assert torch.equal(t, bt) and torch.equal(k, bk), kw


# ---------------------------------------------------------------------------
# Environment switches: the same setting, both packages, the same path
# ---------------------------------------------------------------------------

def test_torch_multipass_visits_parsing(monkeypatch):
    for env, want in (("0", ()), ("off", ()), ("", ()), (" 16,8,8 ",
                                                        (16, 8, 8))):
        monkeypatch.setenv("PT_MULTIPASS", env)
        assert tisect._multipass_visits() == jisect._multipass_visits() \
            == want
    monkeypatch.delenv("PT_MULTIPASS")
    assert tisect._multipass_visits() == jisect._multipass_visits() == ()


def _two_level_pair(monkeypatch, **kw):
    """sanmiguel_analog built by both packages on the two-level tables
    (PT_TWOLEVEL_MIN=0 for both builders), tiny."""
    monkeypatch.setenv("PT_TWOLEVEL_MIN", "0")
    args = dict(resolution=(8, 8), n_tris=3_000, accel="pallas", **kw)
    js = jscenes.sanmiguel_analog(**args)
    ts = tscenes.sanmiguel_analog(device="cpu", **args)
    assert "pk_l1_base" in js[0] and "pk_l1_base" in ts[0]
    return js, ts


def _dispatch_both(js, ts, o, d, t_max, **kw):
    jm = js[2]
    want = jisect._pallas_dispatch(js[0], jm, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), **kw)
    got = tisect._pallas_dispatch(ts[0], ts[2], torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  torch.from_numpy(t_max), **kw)
    return want, got


def _scene_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene["scene_lo"])
    hi = np.asarray(scene["scene_hi"])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = hi[1] * 0.5 + rng.uniform(0, 2, n).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), BIG_F32, np.float32)
    t_max[::9] = 0.0
    return o, d, t_max


def _spy(monkeypatch):
    """Record the keyword arguments of every tri_intersect2 call."""
    calls = []
    real = trace2.tri_intersect2

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(trace2, "tri_intersect2", spy)
    return calls


@pytest.mark.parametrize("switch", ["multipass", "window"])
def test_torch_env_switch_dispatch_matches_jax(monkeypatch, switch):
    """PT_MULTIPASS=2,1,2 (the multipass driver) and PT_WINDOW=4 (the
    window walk), set the same way for both packages: each takes the path
    the switch names (the port's calls are recorded), and the closest and
    any-hit results equal the JAX package's."""
    js, ts = _two_level_pair(monkeypatch, faithful=False)
    o, d, t_max = _scene_rays(ts[0], 256, 3)
    if switch == "multipass":
        monkeypatch.setenv("PT_MULTIPASS", "2,1,2")
    else:
        monkeypatch.setenv("PT_WINDOW", "4")
    calls = _spy(monkeypatch)
    for any_hit in (False, True):
        want, got = _dispatch_both(js, ts, o, d, t_max, any_hit=any_hit)
        v = np.asarray(want["valid"])
        assert 30 < v.sum()
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        if not any_hit:
            np.testing.assert_array_equal(got["idx"].numpy()[v],
                                          np.asarray(want["idx"])[v])
            # the two packages' kernels round t alike to a few ulps
            np.testing.assert_allclose(got["t"].numpy()[v],
                                       np.asarray(want["t"])[v], rtol=1e-5)
    if switch == "multipass":
        assert [c.get("max_visits") for c in calls[:4]] == [2, 1, 2, None]
    else:
        assert calls and all(c["window"] == 4 and c["pops"] == 4
                             for c in calls)


@pytest.mark.parametrize("closest", ["1", "0"])
def test_torch_env_amask_closest_matches_jax(monkeypatch, closest):
    """PT_AMASK_CLOSEST: with "0" the closest pass runs the masked alpha
    tables without amask=1 (a definitely-transparent foliage hit is then
    reported) in both packages; the results equal the JAX package's."""
    monkeypatch.setenv("PT_AMASK_CLOSEST", closest)
    js, ts = _two_level_pair(monkeypatch, foliage=6)
    assert js[2].alpha_cull_mask and ts[2].alpha_cull_mask
    o, d, t_max = _scene_rays(ts[0], 384, 5)
    calls = _spy(monkeypatch)
    want, got = _dispatch_both(js, ts, o, d, t_max)
    assert [c["amask"] for c in calls] == [0, 1 if closest == "1" else 0]
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["idx"].numpy()[v],
                                  np.asarray(want["idx"])[v])
    np.testing.assert_allclose(got["t"].numpy()[v], np.asarray(want["t"])[v],
                               rtol=1e-5)


def test_torch_env_builder_switches_match_jax(monkeypatch):
    """PT_POPS, PT_ALPHA_MASK and PT_TWOLEVEL_MIN set the same build in
    both packages: block_pops, whether masks are attached
    (alpha_cull_mask, pka_mask), and the table level."""
    args = dict(resolution=(8, 8), n_tris=3_000, foliage=4, accel="pallas")
    monkeypatch.setenv("PT_POPS", "2")
    monkeypatch.setenv("PT_ALPHA_MASK", "0")
    js = jscenes.sanmiguel_analog(**args)
    ts = tscenes.sanmiguel_analog(device="cpu", **args)
    assert js[2].block_pops == ts[2].block_pops == 2
    # the JAX tables carry mask words in their rows when alpha_cull_mask,
    # the port's in pka_mask
    assert not js[2].alpha_cull_mask and not ts[2].alpha_cull_mask
    assert "pka_mask" not in ts[0]
    assert "pka_tri" in js[0] and "pka_tri" in ts[0]     # still split
    assert "pk_l1_base" not in js[0] and "pk_l1_base" not in ts[0]
    monkeypatch.delenv("PT_POPS")
    monkeypatch.delenv("PT_ALPHA_MASK")
    monkeypatch.setenv("PT_TWOLEVEL_MIN", "0")
    js = jscenes.sanmiguel_analog(**args)
    ts = tscenes.sanmiguel_analog(device="cpu", **args)
    assert js[2].block_pops == ts[2].block_pops == 4
    assert js[2].alpha_cull_mask and ts[2].alpha_cull_mask
    assert "pka_mask" in ts[0]
    for sc in (js[0], ts[0]):
        assert "pk_l1_base" in sc and "pka_l1_base" in sc
    for k in ("pk_slot2tri", "pka_slot2tri", "pk_l1_base"):
        np.testing.assert_array_equal(ts[0][k].numpy(), np.asarray(js[0][k]),
                                      err_msg=k)
    # the module constant stays the default when the variable is unset
    monkeypatch.delenv("PT_TWOLEVEL_MIN")
    monkeypatch.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    assert "pk_l1_base" in tscenes.sanmiguel_analog(device="cpu", **args)[0]


def test_torch_pops_reach_every_two_level_run(monkeypatch):
    """meta.block_pops is passed to every two-level run of the dispatch
    (opaque and alpha tables)."""
    monkeypatch.setenv("PT_POPS", "3")
    _, ts = _two_level_pair(monkeypatch, foliage=4)
    o, d, t_max = _scene_rays(ts[0], 128, 9)
    calls = _spy(monkeypatch)
    tisect._pallas_dispatch(ts[0], ts[2], torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(t_max))
    tisect._occluded(ts[0], ts[2], torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(t_max))
    assert len(calls) >= 3 and all(c["pops"] == 3 for c in calls)
    assert dataclasses.replace(ts[2]).block_pops == 3
