"""K1's group walk (csrc/trace2.cu with csrc/group_walk.cuh): the coarse
front over the unions of 8 top-level entries and W lanes per ray, and the
window walk on the same front.  The kernel source runs on the CPU through
the host build (each ray's W lanes as W threads), for W = 1 and for the
lane counts the card uses, and is held to the plain version (itself held
to the JAX package's kernel in test_torch_trace2.py and
test_torch_instancing.py) with no lane differing; the coarse tables are
the JAX package's."""
import shutil

import numpy as np
import pytest
import torch

from pathtracing_tpu.accel.pallas_trace2 import build_tri_blocks2 as j_build
from pathtracing_tpu.core.math import BIG_F32
from pathtracing_tpu_torch.accel import cubuild, trace2
from pathtracing_tpu_torch.core.math import _inv_guard
from test_torch_trace1 import (_T, _alpha_cards, _card_masks, _inst_args,
                               _soup)
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)

LANES = (1, 8)          # one lane per ray, and the card's group width
WINDOW_LANES = (1, 8, 16)   # ... and the card's window-walk width


def _rays(seed, n, spread, t_far):
    """Rays from a shell toward the soup's box; every third bounded."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * (2.0 * spread)
    d = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) - o
    d[::17, 2] = 0.0                         # axis-parallel components
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full((n,), BIG_F32, np.float32)
    t_max[::3] = t_far
    t_max[::23] = 0.0                        # dead lanes
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)


def _plain_tables(n_tri=12000, seed=3):
    """World soup tables with many small L1s: >= 9 coarse unions."""
    return _T(trace2.build_tri_blocks2(_soup(seed, n_tri, 4.0), k2=32,
                                       g=4)[0])


def _tables(kind):
    """(tables, time or None, amasks) of a table kind."""
    rng = np.random.default_rng(7)
    if kind == "plain":
        return _plain_tables(), None, (0,)
    if kind == "masked":
        tri_v, uvs = _alpha_cards(8, 1500, spread=6.0)
        return _T(trace2.build_tri_blocks2(tri_v, k2=32, g=4,
                                           tri_mask=_card_masks(uvs))[0]), \
            None, (1, 2)
    if kind == "instanced":
        return _T(trace2.build_tri_blocks2_inst(*_inst_args(9, n_inst=60),
                                                k2=32, g=4)[0]), None, (0,)
    if kind == "instanced_masked":
        wv, wuv = _alpha_cards(10, 300)
        ov, ouv = _alpha_cards(11, 48, spread=1.0, size=(0.5, 1.2))
        _, _, fw, iv, _, _ = _inst_args(12, n_inst=40)
        args = (wv, ov, fw, iv, [0] * 40, [96] * 40)
        return _T(trace2.build_tri_blocks2_inst(
            *args, k2=32, g=4, tri_mask=_card_masks(wuv),
            otri_mask=_card_masks(ouv))[0]), None, (1, 2)
    time = torch.from_numpy(rng.uniform(0, 1, 400).astype(np.float32))
    if kind == "motion":
        tv = _soup(13, 5000, 4.0)
        return _T(trace2.build_tri_blocks2(
            tv, k2=32, g=4, tri_vel=rng.normal(0, .5, (5000, 3)).astype(
                np.float32), shutter=(0.0, 1.0))[0]), time, (0,)
    args = _inst_args(14, n_inst=50)
    return _T(trace2.build_tri_blocks2_inst(
        *args, k2=32, g=4,
        tri_vel=rng.normal(0, .5, (len(args[0]), 3)).astype(np.float32),
        inst_vel=rng.normal(0, .5, (50, 3)).astype(np.float32),
        shutter=(0.0, 1.0))[0]), time, (0,)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """csrc/trace2.cu as host code at each lane count of LANES (the group
    walk's and the window walk's)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    out = tmp_path_factory.mktemp("k1walk")
    return {w: trace2.bind(cubuild.host_library(
        "trace2", out, {"TRACE2_LANES": w, "TRACE2_WINDOW_LANES": w}))
        for w in sorted(set(LANES + WINDOW_LANES))}


def test_torch_k1walk_coarse_tables_match_jax():
    """The unions the kernel's front walks on world tables are the JAX
    package's pk_sblk_lo / pk_sblk_hi (8 consecutive L1s); an instanced
    table's unions (SAH neighbours among its expanded entries) partition
    the entries, list them ascending, and bound them exactly."""
    tri_v = _soup(21, 5000, 4.0)
    ja, _ = j_build(tri_v, k2=32, g=4)
    ta, _ = trace2.build_tri_blocks2(tri_v, k2=32, g=4)
    m1 = ta["pk_l1box"].shape[0]
    box = ta["pk_cbox"]
    assert box.shape == (-(-m1 // 8), 8)
    np.testing.assert_array_equal(box[:, 0:3], ja["pk_sblk_lo"])
    np.testing.assert_array_equal(box[:, 4:7], ja["pk_sblk_hi"])
    np.testing.assert_array_equal(ta["pk_cmem"].ravel()[:m1], np.arange(m1))
    np.testing.assert_array_equal(ta["pk_cgrp"], np.arange(m1) // 8)
    ti, _ = trace2.build_tri_blocks2_inst(*_inst_args(22, n_inst=80), k2=32,
                                          g=4)
    mem, grp, box = ti["pk_cmem"], ti["pk_cgrp"], ti["pk_cbox"]
    m1 = ti["pk_l1box"].shape[0]
    real = mem[mem >= 0]
    assert sorted(real.tolist()) == list(range(m1))
    assert (np.diff(np.where(mem < 0, m1 + np.arange(8), mem), axis=1)
            > 0).all()                                # ascending, pad last
    np.testing.assert_array_equal(grp[real], np.nonzero(mem >= 0)[0])
    np.testing.assert_array_equal(box[:, 3].view(np.int32), mem[:, 0])
    lo = np.where((mem >= 0)[..., None], ti["pk_l1box"][mem, 0:3], np.inf)
    hi = np.where((mem >= 0)[..., None], ti["pk_l1box"][mem, 4:7], -np.inf)
    np.testing.assert_array_equal(box[:, 0:3], lo.min(1))
    np.testing.assert_array_equal(box[:, 4:7], hi.max(1))
    # SAH neighbours: tighter unions than 8 consecutive instance entries
    vol = np.prod(box[:, 4:7] - box[:, 0:3], axis=1).sum()
    cons = trace2.coarse_tables(ti["pk_blk_lo"], ti["pk_blk_hi"])["pk_cbox"]
    assert vol < np.prod(cons[:, 4:7] - cons[:, 0:3], axis=1).sum()


@pytest.mark.parametrize("kind", ["plain", "faithful_like", "instanced"])
def test_torch_k1walk_union_entry_bounds_members(kind):
    """The two facts that make the coarse front exact, under the kernel's
    own slab arithmetic (trace2.slab_entries): a union's entry is <= the
    entry of each member that is entered, and a member that is entered
    has its union entered, for every ray and bound."""
    if kind == "plain":
        tabs = _plain_tables()
    elif kind == "faithful_like":          # long thin triangles, wide span
        tv = _soup(23, 20000, 4.0) * np.float32([40.0, 2.0, 40.0])
        tabs = _T(trace2.build_tri_blocks2(tv, k2=64, g=4)[0])
    else:
        tabs = _T(trace2.build_tri_blocks2_inst(*_inst_args(24, n_inst=80),
                                                k2=32, g=4)[0])
    spread = 160.0 if kind == "faithful_like" else 8.0
    o, d, t_max = _rays(25, 3000, spread, 1.5 * spread)
    inv = _inv_guard(d)
    em = trace2.slab_entries(tabs["pk_l1box"], o, inv, t_max)
    eu = trace2.slab_entries(tabs["pk_cbox"], o, inv, t_max)
    eu = eu[:, tabs["pk_cgrp"].to(torch.int64)]    # each member's union
    entered = em < BIG_F32
    assert tabs["pk_cbox"].shape[0] >= 9 and entered.sum() > 1000
    assert (eu[entered] < BIG_F32).all()
    assert (eu[entered] <= em[entered]).all()
    # the unions are coarser: entered on more (ray, entry) pairs
    assert (eu < BIG_F32).sum() > entered.sum()


@pytest.mark.parametrize("kind", ["plain", "masked", "instanced",
                                  "instanced_masked", "motion",
                                  "instanced_motion"])
@pytest.mark.parametrize("w", LANES)
def test_torch_k1walk_modes_match_plain(host_libs, w, kind):
    """Every mode of the group walk (closest, any-hit, amask 1 / 2; plain,
    instanced, moving, instanced + moving tables) at W lanes per ray equals
    the plain version: the same keys (-2 = solid), bit-equal t, and the
    same occlusion flags; pops 4 changes nothing."""
    tabs, time, amasks = _tables(kind)
    spread = 6.0 if "masked" in kind else 8.0
    o, d, t_max = _rays(27, 400, spread, 1.5 * spread)
    for amask in amasks:
        pt, pk = trace2._plain_slots(tabs, o, d, t_max, amask=amask,
                                     time=time)
        assert (pk >= 0).sum() > 50
        if amask == 2:
            assert (pk == -2).sum() > 20
        for kw in (dict(), dict(pops=4)):
            t, k, _ = trace2._launch_kernel(tabs, o, d, t_max, False, False,
                                            amask, time,
                                            host_lib=host_libs[w], **kw)
            assert torch.equal(k, pk) and torch.equal(t, pt), (amask, kw)
        if amask == 0:
            _, k, _ = trace2._launch_kernel(tabs, o, d, t_max, True, False,
                                            0, time, host_lib=host_libs[w])
            assert torch.equal(k >= 0, pk >= 0)


@pytest.mark.parametrize("kind", ["masked", "instanced_masked"])
@pytest.mark.parametrize("w", WINDOW_LANES)
def test_torch_k1walk_window_masked(host_libs, w, kind):
    """The window walk (windows 2 and 4, pops = 2 * window) at W lanes per
    ray on alpha-masked tables, plain and instanced, as path C runs it on
    its amask 1 / 2 passes: against the window=1, pops=1 walk the same
    keys (-2 = solid) and bit-equal t at amask 1 and 2, and (amask 0) the
    same occlusion flags of any-hit walks; the keys also equal the plain
    version's."""
    tabs, time, amasks = _tables(kind)
    o, d, t_max = _rays(28, 400, 6.0, 9.0)
    lib = host_libs[w]
    for amask in (0,) + amasks:
        for any_hit in ((False, True) if amask == 0 else (False,)):
            bt, bk, _ = trace2._launch_kernel(tabs, o, d, t_max, any_hit,
                                              False, amask, time,
                                              host_lib=lib)
            if not any_hit:
                pt, pk = trace2._plain_slots(tabs, o, d, t_max, amask=amask,
                                             time=time)
                assert torch.equal(bk, pk) and torch.equal(bt, pt), amask
            assert (bk >= 0).sum() > 50
            if amask == 2:
                assert (bk == -2).sum() > 20
            for window in (2, 4):
                t, k, _ = trace2._launch_kernel(
                    tabs, o, d, t_max, any_hit, False, amask, time,
                    host_lib=lib, window=window, pops=2 * window)
                if any_hit:
                    assert torch.equal(k >= 0, bk >= 0), window
                else:
                    assert torch.equal(k, bk) and torch.equal(t, bt), \
                        (amask, window)
