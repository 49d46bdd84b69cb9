"""The single-level traversal of pathtracing_tpu_torch (accel/trace1.py)
against the JAX package's pallas_tri_intersect (interpret mode on the CPU)
and its table builders, in every mode: closest, any-hit, the alpha
micro-mask modes, run-time instances and motion; the kernel source
compiled as host C++ against the plain version; the builder's choice of
tables against the JAX builder's."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.accel import pallas_trace as jt1
from pathtracing_tpu.core.math import BIG_F32
from pathtracing_tpu.scene.alphamask import build_tri_alpha_masks as j_masks
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu.scene.textures import TexturePool as JPool
from pathtracing_tpu_torch.accel import cubuild, trace1
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene.alphamask import build_tri_alpha_masks
from pathtracing_tpu_torch.scene.textures import TexturePool
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _soup(seed, n_tri, spread=6.0, size=0.4):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    return np.stack([v0,
                     v0 + rng.normal(0, size, (n_tri, 3)).astype(np.float32),
                     v0 + rng.normal(0, size, (n_tri, 3)).astype(np.float32)],
                    1)


def _rays(seed, n, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * (spread * 2.0)
    d = rng.uniform(-spread, spread, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full((n,), BIG_F32, np.float32)
    t_max[::3] = 2.2 * spread
    return o.astype(np.float32), d, t_max


def _T(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def _J(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _t3(o, d, t_max):
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)


def _leaf_tex(k=64):
    u, v = np.meshgrid((np.arange(k) + 0.5) / k, (np.arange(k) + 0.5) / k)
    leaf = np.zeros((k, k, 4), np.float32)
    leaf[..., 3] = ((((u - 0.5) / 0.38) ** 2
                     + ((v - 0.5) / 0.47) ** 2) < 1.0).astype(np.float32)
    return leaf


def _alpha_cards(seed, n_cards, spread=6.0, size=(1.0, 2.5)):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_cards, 3))
    s = rng.uniform(*size, (n_cards, 1))
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
    return tri_v, np.ascontiguousarray(uvs)


def _card_masks(uvs, pool_cls=TexturePool, build=build_tri_alpha_masks):
    pool = pool_cls()
    tid = pool.add_image(_leaf_tex())
    return build(uvs, np.zeros(len(uvs), np.int64), pool, [2], [0.5],
                 [[tid, -1, -1, -1, -1]])


def _xf(rng):
    """A sheared, non-uniformly scaled, rotated, translated 4x4."""
    a = rng.uniform(0, np.pi)
    c, s = np.cos(a), np.sin(a)
    lin = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) \
        @ np.diag(rng.uniform(0.5, 2.0, 3))
    lin[0, 1] += 0.3
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = rng.uniform(-5, 5, 3)
    return m.astype(np.float32)


def _inst_args(seed, n_world=1500, n_inst=40):
    """World soup + two models (96 and 200 triangles) under n_inst
    transforms: the arguments of the instanced table builders."""
    rng = np.random.default_rng(seed)
    ov = np.concatenate([_soup(seed + 1, 96, 1.0), _soup(seed + 2, 200, 1.5)])
    fw = [_xf(rng) for _ in range(n_inst)]
    iv = [np.linalg.inv(f).astype(np.float32) for f in fw]
    n0 = (n_inst * 5) // 8
    base = [0] * n0 + [96] * (n_inst - n0)
    cnt = [96] * n0 + [200] * (n_inst - n0)
    return (_soup(seed + 3, n_world), ov, [f[:3, :4] for f in fw],
            [f[:3, :4] for f in iv], base, cnt)


def _same(a, b, keys=("valid", "tri", "inst", "t")):
    for k in keys:
        assert torch.equal(a[k], b[k]), (k, int((a[k] != b[k]).sum()))


def _same_as_jax(got, want, rtol=1e-5):
    """valid / tri / inst equal, t to rtol on the hit lanes."""
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["tri"].numpy()[v],
                                  np.asarray(want["tri"])[v])
    np.testing.assert_array_equal(got["inst"].numpy()[v],
                                  np.asarray(want["inst"])[v])
    np.testing.assert_allclose(got["t"].numpy()[v], np.asarray(want["t"])[v],
                               rtol=rtol)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tri,motion", [(3000, False), (9000, False),
                                          (3000, True)])
def test_torch_trace1_tables_match_jax(n_tri, motion):
    tri_v = _soup(13, n_tri)
    kw = {}
    if motion:
        kw = dict(tri_vel=np.random.default_rng(1).normal(
            0, 1, (n_tri, 3)).astype(np.float32), shutter=(0.25, 1.0))
    ja, jk = jt1.build_tri_blocks(tri_v, **kw)
    ta, tk = trace1.build_tri_blocks(tri_v, **kw)
    assert jk == tk and tk % 128 == 0
    assert trace1.pick_block_k(n_tri) == __import__(
        "pathtracing_tpu.accel.beam", fromlist=["x"]).pick_block_k(n_tri)
    np.testing.assert_array_equal(ta["pk_slot2tri"], ja["pk_slot2tri"])
    for k in ("pk_blk_lo", "pk_blk_hi", "pk_sblk_lo", "pk_sblk_hi"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-6, err_msg=k)
    assert ta["pk_tri"].shape == (len(ta["pk_blkbox"]), tk, 12)
    np.testing.assert_array_equal(ta["pk_tri"].reshape(-1, 12).T,
                                  ja["pk_tri"][:12])
    np.testing.assert_array_equal(ta["pk_blkbox"][:, [0, 1, 2, 4, 5, 6]],
                                  np.concatenate([ta["pk_blk_lo"],
                                                  ta["pk_blk_hi"]], 1))


def test_torch_trace1_mask_words_match_jax():
    tri_v, uvs = _alpha_cards(40, 300)
    masks = _card_masks(uvs)
    ta, _ = trace1.build_tri_blocks(tri_v, tri_mask=masks)
    ja, _ = jt1.build_tri_blocks(tri_v, tri_mask=_card_masks(uvs, JPool,
                                                             j_masks))
    pm = ta["pk_mask"]
    assert pm.dtype == np.int32 and pm.shape == (len(ta["pk_slot2tri"]), 8)
    np.testing.assert_array_equal(pm[:, :7].T,
                                  np.ascontiguousarray(ja["pk_tri"][9:16])
                                  .view(np.int32))
    with pytest.raises(ValueError):
        trace1.build_tri_blocks(tri_v, tri_mask=masks,
                                tri_vel=np.zeros((600, 3), np.float32))


def test_torch_trace1_inst_tables_match_jax():
    args = _inst_args(5)
    ta, tk = trace1.build_tri_blocks_inst(*args)
    ja, jk = jt1.build_tri_blocks_inst(*args)
    assert tk == jk
    for k in ("pk_slot2tri", "pk_blk_src", "pk_blk_inst"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    for k in ("pk_blk_lo", "pk_blk_hi", "pk_inst_inv", "pk_inst_fwd"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-6, err_msg=k)
    data = ta["pk_slot2tri"] >= 0
    rows = ta["pk_tri"].reshape(-1, 12)
    assert ta["pk_tri"].shape == (int(ta["pk_blk_src"].max()) + 1, tk, 12)
    np.testing.assert_array_equal(rows[data, :9], ja["pk_tri"][:9].T[data])
    assert not rows[~data].any()


# ---------------------------------------------------------------------------
# The contract, against the JAX kernel and the brute force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["static", "motion", "inst"])
def test_torch_trace1_matches_pallas_kernel(mode):
    """Closest and any-hit against pallas_tri_intersect (interpret mode):
    valid, tri, inst equal, t to rtol=1e-5; the culled plain version equals
    the brute force over every slot exactly."""
    n = 384
    o, d, t_max = _rays(32, n)
    kw, jkw = {}, {}
    if mode == "inst":
        args = _inst_args(7)
        ta, k = trace1.build_tri_blocks_inst(*args)
        ja, _ = jt1.build_tri_blocks_inst(*args)
    else:
        tri_v = _soup(31, 3000)
        if mode == "motion":
            vel = np.random.default_rng(2).normal(0, 1, (3000, 3)) \
                .astype(np.float32)
            tme = np.random.default_rng(3).uniform(0, 1, n).astype(np.float32)
            kw = dict(tri_vel=vel, shutter=(0.0, 1.0))
            jkw = dict(time=jnp.asarray(tme))
        ta, k = trace1.build_tri_blocks(tri_v, **kw)
        ja, _ = jt1.build_tri_blocks(tri_v, **kw)
    tkw = dict(time=torch.from_numpy(tme)) if mode == "motion" else {}
    tabs = _T(ta)
    got = trace1.tri_intersect1(tabs, *_t3(o, d, t_max), **tkw)
    brute = trace1.tri_intersect1_plain(tabs, *_t3(o, d, t_max), prune=False,
                                        **tkw)
    _same(got, brute)
    assert int(got["valid"].sum()) > 100
    if mode == "inst":
        assert int((got["inst"] >= 0).sum()) > 50
        assert int((got["valid"] & (got["inst"] < 0)).sum()) > 20
    for any_hit in (False, True):
        want = jt1.pallas_tri_intersect(_J(ja), jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(t_max), k,
                                        any_hit=any_hit, **jkw)
        if any_hit:
            np.testing.assert_array_equal(np.asarray(want["valid"]),
                                          got["valid"].numpy())
        else:
            _same_as_jax(got, want)


@pytest.mark.parametrize("amask", [1, 2])
def test_torch_trace1_amask_matches_pallas_kernel(amask):
    """The alpha micro-mask modes against the JAX single-level kernel.
    Mode 1: valid, tri equal, t to rtol=1e-5.  Mode 2: the JAX kernel's
    `solid` depends on its visit order, the port's does not, so the four
    relations hold: the same miss lanes; port-solid => JAX-solid;
    JAX-solid => solid or candidate here; where both report a candidate
    it is the same one."""
    tri_v, uvs = _alpha_cards(41, 250)
    ta, k = trace1.build_tri_blocks(tri_v, tri_mask=_card_masks(uvs))
    ja, _ = jt1.build_tri_blocks(tri_v, tri_mask=_card_masks(uvs, JPool,
                                                             j_masks))
    o, d, t_max = _rays(42, 256)
    want = jt1.pallas_tri_intersect(_J(ja), jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_max), k, amask=amask)
    tabs = _T(ta)
    got = trace1.tri_intersect1(tabs, *_t3(o, d, t_max), amask=amask)
    brute = trace1.tri_intersect1_plain(tabs, *_t3(o, d, t_max), amask=amask,
                                        prune=False)
    for key in brute:
        assert torch.equal(got[key], brute[key]), key
    vj, vt = np.asarray(want["valid"]), got["valid"].numpy()
    if amask == 1:
        _same_as_jax(got, want)
        plain0 = trace1.tri_intersect1(tabs, *_t3(o, d, t_max))
        assert 20 < vt.sum() < int(plain0["valid"].sum())
        return
    sj, st = np.asarray(want["solid"]), got["solid"].numpy()
    assert st.sum() > 10 and (vt & ~st).sum() > 10
    np.testing.assert_array_equal(~vt & ~st, ~vj & ~sj)      # miss lanes
    assert not (st & ~sj).any()           # port-solid => JAX-solid
    assert not (sj & ~(st | vt)).any()    # JAX-solid => solid or candidate
    both = vt & vj
    np.testing.assert_array_equal(got["tri"].numpy()[both],
                                  np.asarray(want["tri"])[both])


def test_torch_trace1_refuses_what_its_tables_lack():
    args = _inst_args(9, n_world=200, n_inst=4)
    ta, _ = trace1.build_tri_blocks_inst(*args)
    o, d, t_max = _rays(2, 8)
    for fn in (trace1.tri_intersect1, trace1.tri_intersect1_plain):
        with pytest.raises(ValueError, match="neither"):
            fn(_T(ta), *_t3(o, d, t_max), time=torch.zeros(8))
        with pytest.raises(ValueError, match="pk_mask"):
            fn(_T(ta), *_t3(o, d, t_max), amask=1)
    with pytest.raises(ValueError, match="counters"):
        trace1.tri_intersect1(_T(ta), *_t3(o, d, t_max), counters=True)


# ---------------------------------------------------------------------------
# The kernel source as host C++
# ---------------------------------------------------------------------------

LANES = (1, 16)         # one lane per ray, and the card's group width


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """csrc/trace1.cu compiled as plain C++ (no FMA contraction) at each
    lane count of LANES: the kernel's group walk on the CPU, each ray's W
    lanes as W threads meeting at a barrier in every group primitive."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    out = tmp_path_factory.mktemp("trace1_host")
    return {w: trace1.bind(cubuild.host_library(
        "trace1", out, {"TRACE1_LANES": w})) for w in LANES}


def _host(lib, tabs, o, d, t_max, any_hit=False, amask=0, time=None,
          counters=False):
    t, k, cnt = trace1._launch_kernel(tabs, *_t3(o, d, t_max), any_hit,
                                      counters, amask, time=time,
                                      host_lib=lib)
    return (t, k, cnt) if counters else (t, k)


@pytest.mark.parametrize("mode", ["static", "big", "motion", "inst",
                                  "amask1", "amask2"])
@pytest.mark.parametrize("w", LANES)
def test_torch_trace1_kernel_source_matches_plain(host_libs, w, mode):
    """The CUDA kernel's group walk (the coarse front with its refills and
    union expansions, W lanes per block, the instance transform, the
    motion shift, the mask modes, the any-hit vote) equals the plain
    version at W lanes per ray: the same keys (-2 = solid), bit-equal t,
    0 flips (fewer rays for the threaded build: its barriers are slow)."""
    n = 500 if w == 1 else 300
    spread = 18.0 if mode == "big" else 6.0
    o, d, t_max = _rays(52, n, spread)
    t_max[::23] = 0.0                                 # dead lanes
    kw, amask = {}, 0
    # the small sets in blocks of 32 (the kernel takes any K): >= 9 unions
    bk = None if mode == "big" else 32
    if mode == "inst":
        ta, _ = trace1.build_tri_blocks_inst(*_inst_args(11), block_k=bk)
    elif mode in ("amask1", "amask2"):
        tri_v, uvs = _alpha_cards(51, 1500)
        ta, _ = trace1.build_tri_blocks(tri_v, tri_mask=_card_masks(uvs),
                                        block_k=bk)
        amask = int(mode[-1])
    else:
        nt = 60000 if mode == "big" else 3000
        tri_v = _soup(31, nt, spread, 0.4 * spread / 6.0)
        bkw = {}
        if mode == "motion":
            bkw = dict(tri_vel=np.random.default_rng(2).normal(
                0, 1, (nt, 3)).astype(np.float32), shutter=(0.0, 1.0))
            kw = dict(time=torch.from_numpy(np.random.default_rng(3).uniform(
                0, 1, n).astype(np.float32)))
        ta, _ = trace1.build_tri_blocks(tri_v, block_k=bk, **bkw)
    tabs = _T(ta)
    assert tabs["pk_cbox"].shape[0] >= 9        # several unions
    pt, pk = trace1._plain_slots(tabs, *_t3(o, d, t_max), amask=amask, **kw)
    ht, hk = _host(host_libs[w], tabs, o, d, t_max, amask=amask, **kw)
    assert (pk >= 0).sum() > 50
    if amask == 2:
        assert (pk == -2).sum() > 50
    assert torch.equal(hk, pk) and torch.equal(ht, pt)
    if not amask:
        _, hk_any = _host(host_libs[w], tabs, o, d, t_max, any_hit=True, **kw)
        assert torch.equal(hk_any >= 0, pk >= 0)


def test_torch_trace1_coarse_tables():
    """The unions K2's front walks on world tables are the JAX package's
    pk_sblk_lo / pk_sblk_hi (8 consecutive blocks); an instanced table's
    unions (SAH neighbours among its expanded blocks) partition the
    blocks, list them ascending, bound them exactly, and are tighter
    than 8 consecutive expanded blocks."""
    tri_v = _soup(21, 9000)
    ja, _ = jt1.build_tri_blocks(tri_v)
    ta, _ = trace1.build_tri_blocks(tri_v)
    m = ta["pk_blkbox"].shape[0]
    box = ta["pk_cbox"]
    assert box.shape == (-(-m // 8), 8) and box.shape[0] >= 2
    np.testing.assert_array_equal(box[:, 0:3], ja["pk_sblk_lo"])
    np.testing.assert_array_equal(box[:, 4:7], ja["pk_sblk_hi"])
    np.testing.assert_array_equal(ta["pk_cmem"].ravel()[:m], np.arange(m))
    np.testing.assert_array_equal(ta["pk_cgrp"], np.arange(m) // 8)
    ti, _ = trace1.build_tri_blocks_inst(*_inst_args(22, n_inst=80),
                                         block_k=128)
    mem, grp, box = ti["pk_cmem"], ti["pk_cgrp"], ti["pk_cbox"]
    m = ti["pk_blkbox"].shape[0]
    real = mem[mem >= 0]
    assert sorted(real.tolist()) == list(range(m)) and m > 64
    assert (np.diff(np.where(mem < 0, m + np.arange(8), mem), axis=1)
            > 0).all()                                # ascending, pad last
    np.testing.assert_array_equal(grp[real], np.nonzero(mem >= 0)[0])
    np.testing.assert_array_equal(box[:, 3].view(np.int32), mem[:, 0])
    lo = np.where((mem >= 0)[..., None], ti["pk_blkbox"][mem, 0:3], np.inf)
    hi = np.where((mem >= 0)[..., None], ti["pk_blkbox"][mem, 4:7], -np.inf)
    np.testing.assert_array_equal(box[:, 0:3], lo.min(1))
    np.testing.assert_array_equal(box[:, 4:7], hi.max(1))
    vol = np.prod(box[:, 4:7] - box[:, 0:3], axis=1).sum()
    cons = trace1.coarse_tables(ti["pk_blk_lo"], ti["pk_blk_hi"])["pk_cbox"]
    assert vol < np.prod(cons[:, 4:7] - cons[:, 0:3], axis=1).sum()


@pytest.mark.parametrize("kind", ["plain", "instanced"])
def test_torch_trace1_union_entry_bounds_members(kind):
    """The two facts that make K2's coarse front exact, under the kernel's
    slab arithmetic (trace2.slab_entries): a union's entry is <= the
    entry of each member block that is entered, and an entered block has
    its union entered, for every ray and bound."""
    from pathtracing_tpu_torch.accel.trace2 import slab_entries
    from pathtracing_tpu_torch.scene.intersect import _inv_guard
    if kind == "plain":
        tabs = _T(trace1.build_tri_blocks(_soup(23, 20000, 6.0, 0.6))[0])
    else:
        tabs = _T(trace1.build_tri_blocks_inst(*_inst_args(24, n_inst=80),
                                               block_k=128)[0])
    o, d, t_max = _t3(*_rays(25, 3000, 6.0))
    em = slab_entries(tabs["pk_blkbox"], o, _inv_guard(d), t_max)
    eu = slab_entries(tabs["pk_cbox"], o, _inv_guard(d), t_max)
    eu = eu[:, tabs["pk_cgrp"].to(torch.int64)]     # each block's union
    entered = em < BIG_F32
    assert tabs["pk_cbox"].shape[0] >= 9 and entered.sum() > 1000
    assert (eu[entered] < BIG_F32).all()
    assert (eu[entered] <= em[entered]).all()
    assert (eu < BIG_F32).sum() > entered.sum()      # the unions are coarser


@pytest.mark.parametrize("w", LANES)
def test_torch_trace1_kernel_counters(host_libs, w):
    """counters is [N, 5]: front refills, blocks visited, leaf blocks (the
    same), mask lookups, and top-level slab tests, the fifth at most
    refills x M (the flat scan's count) and below it in sum; the visited
    blocks are the touched ones."""
    tri_v = _soup(31, 9000)
    tabs = _T(trace1.build_tri_blocks(tri_v)[0])
    m = tabs["pk_blkbox"].shape[0]
    o, d, t_max = _rays(53, 300)
    t, k, cnt = _host(host_libs[w], tabs, o, d, t_max, counters=True)
    c = cnt["counters"]
    assert c.shape == (300, 5) and c.dtype == torch.int32
    assert torch.equal(c[:, 1], c[:, 2]) and not c[:, 3].any()
    live = torch.from_numpy(t_max) > 0
    assert (c[live, 0] >= 1).all() and (c[live, 4] >= 1).all()
    assert (c[:, 4] <= c[:, 0] * m).all()
    assert int(c[:, 4].sum()) < int((c[:, 0] * m).sum())
    assert int(cnt["blocks_touched"].sum()) > 0 and (c[:, 1] > 0).any()
    assert torch.equal(k, trace1._plain_slots(tabs, *_t3(o, d, t_max))[1])


# ---------------------------------------------------------------------------
# Which tables the builder chooses
# ---------------------------------------------------------------------------

def _grid_mesh(side):
    x, z = np.meshgrid(np.linspace(-3, 3, side), np.linspace(-3, 3, side))
    y = 0.4 * np.sin(2 * x) * np.cos(2 * z)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1),
                       indexing="ij")
    a = (i * side + j).ravel()
    f = np.concatenate([np.stack([a, a + 1, a + side], -1),
                        np.stack([a + 1, a + side + 1, a + side], -1)])
    return v, f.astype(np.int32)


def _choice_scene(B, case):
    """The cases of the builder's table choice, for either package."""
    b = B()
    mat = b.add_diffuse((0.7, 0.5, 0.3))
    v, f = _grid_mesh(52)                       # 5,202 triangles
    pv = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                     [0, 1.2, 0]], np.float32)
    pf = np.asarray([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                     [0, 2, 1], [0, 3, 2]], np.int32)
    shutter = (0.0, 0.0)
    if case == "small":
        b.add_mesh(v, f, material=mat)
    elif case == "motion":
        b.add_mesh(v, f, material=mat, velocity=(1.5, 0.0, 0.0))
        shutter = (0.0, 1.0)
    elif case == "alpha_split":
        leaf = b.textures.add_image(_leaf_tex())
        am = b.add_diffuse((1, 1, 1), base_tex=leaf, alpha_mode=2)
        b.add_mesh(v, f, material=mat)
        uv = (v[:, [0, 2]] / 6.0 + 0.5).astype(np.float32)
        b.add_mesh(v + np.asarray([0, 2, 0], np.float32), f, uvs=uv,
                   material=am)
    elif case in ("inst", "inst_motion", "inst_alpha"):
        b.add_mesh(v, f, material=mat)
        mid_mat = mat
        if case == "inst_alpha":
            leaf = b.textures.add_image(_leaf_tex())
            mid_mat = b.add_diffuse((1, 1, 1), base_tex=leaf, alpha_mode=2)
        mid = b.add_model(pv, pf, uvs=np.zeros((5, 2), np.float32) + 0.5,
                          material=mid_mat)
        for k in range(3):
            tf = np.eye(4, dtype=np.float32)
            tf[:3, 3] = [2.0 * k - 2, 1.0, 0.5 * k]
            b.add_model_instance(
                mid, tf, runtime=True,
                velocity=(1.0, 0, 0) if case == "inst_motion" and k == 0
                else (0.0, 0.0, 0.0))
        if case == "inst_motion":
            shutter = (0.0, 1.0)
    b.add_uniform_inf_light((1, 1, 1))
    b.set_camera([0, 4, -7], [0, 0, 0], math.radians(40), (8, 8),
                 shutter=shutter)
    return b


@pytest.mark.parametrize("case", ["small", "small_forced_two", "motion",
                                  "alpha_split", "inst", "inst_motion",
                                  "inst_alpha"])
def test_torch_builder_chooses_tables_like_jax(case, monkeypatch):
    """Sets of 65,536 triangles or fewer and small unsplit static
    instanced scenes get the single-level tables, everything else the
    two-level ones, exactly where the JAX builder does: the same
    "pk_l1_base" in scene, the same block sizes, slot ids and expansion
    tables."""
    if case == "small_forced_two":
        monkeypatch.setenv("PT_TWOLEVEL_MIN", "0")
        monkeypatch.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    name = "small" if case == "small_forced_two" else case
    js, _, jm = _choice_scene(JBuilder, name).build(accel="pallas")
    ts, _, tm = _choice_scene(tbuilder.SceneBuilder, name).build(
        accel="pallas", device="cpu")
    assert tm.accel == jm.accel == "pallas"
    two = {"small": False, "small_forced_two": True, "motion": False,
           "alpha_split": False, "inst": False, "inst_motion": True,
           "inst_alpha": True}[case]
    assert ("pk_l1_base" in ts) == ("pk_l1_base" in js) == two
    assert (tm.block_k, tm.alpha_block_k, tm.alpha_cull_mask, tm.n_inst,
            tm.n_obj_tri, tm.has_motion) == \
        (jm.block_k, jm.alpha_block_k, jm.alpha_cull_mask, jm.n_inst,
         jm.n_obj_tri, jm.has_motion)
    for prefix in ("pk_", "pka_"):
        assert (prefix + "tri" in ts) == (prefix + "tri" in js)
        if prefix + "tri" not in ts:
            continue
        assert (prefix + "l1_base" in ts) == (prefix + "l1_base" in js)
        for k in ("slot2tri", "blk_src", "blk_inst", "l1_base"):
            assert (prefix + k in ts) == (prefix + k in js), prefix + k
            if prefix + k in ts:
                np.testing.assert_array_equal(ts[prefix + k].numpy(),
                                              np.asarray(js[prefix + k]))
        for k in ("blk_lo", "blk_hi"):
            np.testing.assert_allclose(ts[prefix + k].numpy(),
                                       np.asarray(js[prefix + k]), rtol=1e-6)
        assert (prefix + "mask" in ts) == (tm.alpha_cull_mask
                                           and prefix == "pka_")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_torch_trace1_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace1 kernel has no CPU mode")
    o, d, t_max = (x.cuda() for x in _t3(*_rays(14, 4096)))
    tri_v = _soup(13, 20000)
    scene = {k: v.cuda() for k, v in
             _T(trace1.build_tri_blocks(tri_v)[0]).items()}
    got = trace1.tri_intersect1(scene, o, d, t_max)
    ref = trace1.tri_intersect1_plain(scene, o, d, t_max, prune=False)
    torch.cuda.synchronize()
    _same(got, ref)
    scene = {k: v.cuda() for k, v in
             _T(trace1.build_tri_blocks_inst(*_inst_args(3))[0]).items()}
    _same(trace1.tri_intersect1(scene, o, d, t_max),
          trace1.tri_intersect1_plain(scene, o, d, t_max, prune=False))


# ---------------------------------------------------------------------------
# The small courtyard: every triangle set on the single-level kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_courtyard():
    """The San-Miguel analog at the size of one imported model: 20K
    terrain + 8 flattened shrubs, both table sets single-level, beside its
    brute build."""
    from pathtracing_tpu_torch import scenes as tscenes
    kw = dict(resolution=(32, 18), n_tris=20_000, foliage=8)
    return (tscenes.sanmiguel_analog(device="cpu", **kw),
            tscenes.sanmiguel_analog(accel="brute", device="cpu", **kw))


def test_torch_small_courtyard_runs_single_level_tables(small_courtyard):
    """Closest hits equal the brute scan's except where the masked pass
    skips a transparent foliage hit; the shadow predicate (any-hit on the
    opaque tables, the amask=2 restart chain on the alpha tables) equals
    the brute one lane for lane (MASK mode is deterministic)."""
    from pathtracing_tpu_torch import scenes as tscenes
    from pathtracing_tpu_torch.scene import intersect as tisect
    (ts, _, tm), (bs, _, bm) = small_courtyard
    assert tm.accel == "pallas" and tm.alpha_cull_mask and tm.n_inst == 0
    assert "pk_l1_base" not in ts and "pka_l1_base" not in ts
    assert "pka_mask" in ts and "pk_blkbox" in ts and "pka_blkbox" in ts
    rng = np.random.default_rng(23)
    n = 1024
    x = rng.uniform(3.0, 97.0, n).astype(np.float32)
    z = rng.uniform(3.0, 97.0, n).astype(np.float32)
    alpha_v = ts["tri_v"][ts["pka_slot2tri"][ts["pka_slot2tri"] >= 0].long()]
    c = alpha_v.reshape(-1, 3).numpy()
    pick = rng.integers(0, len(c), n // 2)
    x[: n // 2] = c[pick, 0] + rng.normal(0, 0.7, n // 2)
    z[: n // 2] = c[pick, 2] + rng.normal(0, 0.7, n // 2)
    y = tscenes._sm_height(x, z) + rng.uniform(0.05, 2.5, n).astype(np.float32)
    o = torch.from_numpy(np.stack([x, y, z], -1).astype(np.float32))
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d)
    hp = tisect.intersect(ts, tm, o, d, 1e30, device="cpu")
    hb = tisect.intersect(bs, bm, o, d, 1e30, device="cpu")
    miss = ~hp["valid"] & ~hb["valid"]
    same = hp["valid"] & hb["valid"] & (hp["idx"] == hb["idx"]) \
        & (hp["kind"] == hb["kind"])
    is_alpha = torch.zeros(tm.n_tri, dtype=torch.bool)
    is_alpha[ts["pka_slot2tri"][ts["pka_slot2tri"] >= 0].long()] = True
    foliage_b = hb["valid"] & (hb["kind"] == 0) \
        & is_alpha[hb["idx"].clamp(0, tm.n_tri - 1)]
    assert int(foliage_b.sum()) > 30 and int((same & foliage_b).sum()) > 10
    assert bool((same | miss | foliage_b).all())
    assert torch.allclose(hp["t"][same], hb["t"][same], rtol=1e-5)
    tmx = torch.full((n,), 1e30)
    op = tisect.occluded(ts, tm, o, d, tmx, device="cpu")
    ob = tisect.occluded(bs, bm, o, d, tmx, device="cpu")
    assert 0 < int(op.sum()) < n and torch.equal(op, ob)


def test_torch_small_courtyard_render_matches_brute(small_courtyard):
    """The depth-2 render on the single-level tables with the masks left
    unused agrees with the brute build's on > 99% of values (rtol=1e-4,
    atol=1e-5; depth 2 because this scene's normal map decorrelates paths
    after that, as for the two-level build); with the masks on, the
    see-through paths differ sample by sample and the means agree within
    5%."""
    import dataclasses
    from pathtracing_tpu_torch.core.rng import SamplerConfig
    from pathtracing_tpu_torch.integrators.path import RenderConfig
    from pathtracing_tpu_torch.integrators.render import render_image
    (ts, tc, tm), (bs, _, bm) = small_courtyard
    cfg = RenderConfig(spp=2, max_depth=2, regenerate=True,
                       sampler=SamplerConfig(x_samples=2, y_samples=1, seed=3))
    want = render_image(bs, tc, bm, cfg, device="cpu")
    exact = render_image(ts, tc, dataclasses.replace(tm, alpha_cull_mask=False),
                         cfg, device="cpu")
    assert float(torch.isclose(exact, want, rtol=1e-4, atol=1e-5)
                 .float().mean()) > 0.99
    got = render_image(ts, tc, tm, cfg, device="cpu")
    assert abs(float(got.mean()) - float(want.mean())) \
        < 0.05 * float(want.mean())
