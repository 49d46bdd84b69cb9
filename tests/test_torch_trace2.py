"""The two-level traversal of pathtracing_tpu_torch (accel/trace2.py)
against the JAX package's pallas_tri_intersect2 (interpret mode on the
CPU) and its table builder, in its closest, any-hit and alpha micro-mask
modes, plus the dispatch around it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.accel.pallas_trace2 import (
    build_tri_blocks2 as j_build, pallas_tri_intersect2)
from pathtracing_tpu.core.math import BIG_F32
from pathtracing_tpu.scene.alphamask import build_tri_alpha_masks as j_masks
from pathtracing_tpu.scene.textures import TexturePool as JPool
from pathtracing_tpu.scene import intersect as jisect
from pathtracing_tpu_torch.accel import trace2
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene.alphamask import build_tri_alpha_masks
from pathtracing_tpu_torch.scene.textures import TexturePool
from pathtracing_tpu_torch.scene.types import SceneMeta
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _soup(seed, n_tri):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-6, 6, (n_tri, 3)).astype(np.float32)
    return np.stack([v0,
                     v0 + rng.normal(0, .4, (n_tri, 3)).astype(np.float32),
                     v0 + rng.normal(0, .4, (n_tri, 3)).astype(np.float32)],
                    1)


def _rays(seed, n, spread=6.0):
    """Rays from a shell toward the soup (the JAX package's test rays)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * (spread * 2.0)
    target = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


def _port_tables(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


@pytest.mark.parametrize("g", [16, 32])
def test_torch_trace2_tables_match_jax(g):
    tri_v = _soup(13, 3000)
    ja, jk2 = j_build(tri_v, g=g)
    ta, tk2 = trace2.build_tri_blocks2(tri_v, g=g)
    assert jk2 == tk2
    for k in ("pk_blk_lo", "pk_blk_hi", "pk_l1_base", "pk_slot2tri"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # the port's packed triangle rows hold the same v0/e1/e2 per slot
    m1, w = ja["pk_l1_base"].shape[0], g * jk2 + 128
    jtri = ja["pk_tri"].reshape(16, m1, w)[:9, :, :g * jk2].reshape(9, -1)
    np.testing.assert_array_equal(ta["pk_tri"][:, :9].T, jtri)
    # and the same child boxes (the JAX rows' child-box lanes after the
    # triangle columns: lo xyz, hi xyz per child)
    jbox = ja["pk_tri"].reshape(16, m1, w)[:6, :, g * jk2:g * jk2 + g]
    np.testing.assert_array_equal(ta["pk_l2box"][:, [0, 1, 2, 4, 5, 6]],
                                  jbox.reshape(6, -1).T)


def test_torch_trace2_child_boxes_hold_their_triangles():
    """Every child box holds each vertex of its K2 triangles, and padded
    children are far-point boxes: the plain version's pruning by child
    box (and the kernel's) can drop no hit."""
    tri_v = _soup(17, 5000)
    ta, k2 = trace2.build_tri_blocks2(tri_v, g=32)
    tabs = _port_tables(ta)
    tv = torch.from_numpy(tri_v)
    assert trace2.child_boxes_hold_triangles(tabs, tv)
    m2 = ta["pk_l2box"].shape[0]
    pad_child = ta["pk_slot2tri"].reshape(m2, k2)[:, 0] < 0
    assert pad_child.any()                  # 5000 tris, 32 children/L1
    # a child box one ulp short of its farthest vertex is caught
    far_x = tri_v[ta["pk_slot2tri"][3 * k2:4 * k2]][..., 0].max()
    tabs["pk_l2box"][3, 4] = float(np.nextafter(far_x, np.float32(-1e30)))
    assert not trace2.child_boxes_hold_triangles(tabs, tv)
    # so is a padded child that is not a far-point box
    tabs = _port_tables(ta)
    tabs["pk_l2box"][int(np.argmax(pad_child)), :3] = 0.0
    assert not trace2.child_boxes_hold_triangles(tabs, tv)


@pytest.mark.parametrize("any_hit", [False, True])
def test_torch_trace2_pruned_plain_equals_brute(any_hit):
    """The plain version's pruning by padded child box changes nothing:
    it equals Moller-Trumbore over every slot of the table."""
    tri_v = _soup(19, 4000)
    ta, _ = trace2.build_tri_blocks2(tri_v)
    tabs = _port_tables(ta)
    o, d = _rays(20, 400)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((400,), BIG_F32)
    t_max[::4] = 10.0
    pruned = trace2.tri_intersect2_plain(tabs, o, d, t_max, any_hit=any_hit)
    brute = trace2.tri_intersect2_plain(tabs, o, d, t_max, any_hit=any_hit,
                                        prune=False)
    assert 50 < int(brute["valid"].sum()) < 400
    for k in ("valid", "tri", "t"):
        assert torch.equal(pruned[k], brute[k]), k


@pytest.mark.parametrize("any_hit", [False, True])
def test_torch_trace2_plain_matches_pallas_kernel(any_hit):
    tri_v = _soup(13, 3000)
    ja, jk2 = j_build(tri_v)
    ta, _ = trace2.build_tri_blocks2(tri_v)
    o, d = _rays(14, 256)
    t_max = np.full((256,), BIG_F32, np.float32)
    t_max[::7] = 9.0                         # some bounded rays too
    got_j = pallas_tri_intersect2({k: jnp.asarray(v) for k, v in ja.items()},
                                  jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(t_max), jk2, any_hit=any_hit)
    got_t = trace2.tri_intersect2(_port_tables(ta), torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  torch.from_numpy(t_max), any_hit=any_hit)
    v = np.asarray(got_j["valid"])
    assert 20 < v.sum() < 256
    np.testing.assert_array_equal(got_t["valid"].numpy(), v)
    np.testing.assert_array_equal(got_t["inst"].numpy(), -1)
    if not any_hit:
        np.testing.assert_array_equal(got_t["tri"].numpy()[v],
                                      np.asarray(got_j["tri"])[v])
        np.testing.assert_allclose(got_t["t"].numpy()[v],
                                   np.asarray(got_j["t"])[v], rtol=1e-5)
    else:
        # any-hit reports SOME occluder (the first one the traversal finds,
        # so it depends on visit order): check each one is really hit
        for res in (got_t, got_j):
            tri = np.asarray(res["tri"])[v]
            from pathtracing_tpu_torch.scene.intersect import _tri_hits
            tv = torch.from_numpy(tri_v[tri])
            t, ok = _tri_hits(torch.from_numpy(o[v]), torch.from_numpy(d[v]),
                              tv[:, 0], tv[:, 1], tv[:, 2])
            own = ok.diagonal().numpy() & (t.diagonal().numpy() < t_max[v])
            assert own.all()


def test_torch_trace2_miss_contract():
    tri_v = _soup(3, 500)
    ta, _ = trace2.build_tri_blocks2(tri_v)
    o, d = _rays(4, 64)
    res = trace2.tri_intersect2(_port_tables(ta), torch.from_numpy(o),
                                torch.from_numpy(d), torch.zeros(64))
    # t_max = 0: nothing can be hit
    assert not res["valid"].any()
    assert (res["t"] == BIG_F32).all() and (res["tri"] == -1).all()


def _leaf_tex(k=64):
    u, v = np.meshgrid((np.arange(k) + 0.5) / k, (np.arange(k) + 0.5) / k)
    leaf = np.zeros((k, k, 4), np.float32)
    leaf[..., 3] = ((((u - 0.5) / 0.38) ** 2
                     + ((v - 0.5) / 0.47) ** 2) < 1.0).astype(np.float32)
    return leaf


def _alpha_cards(seed, n_cards, spread=6.0, size=(1.0, 2.5)):
    """n_cards alpha-cutout cards (2 triangles each) scattered in a box:
    (tri_v [2n,3,3], uvs [2n,3,2])."""
    rng = np.random.default_rng(seed)
    tri_v, uvs = [], []
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for _ in range(n_cards):
        c = rng.uniform(-spread, spread, 3)
        s = rng.uniform(*size)
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        b = np.cross(a, rng.normal(size=3))
        b /= np.linalg.norm(b)
        q = np.array([c - 0.5 * s * a - 0.5 * s * b,
                      c + 0.5 * s * a - 0.5 * s * b,
                      c + 0.5 * s * a + 0.5 * s * b,
                      c - 0.5 * s * a + 0.5 * s * b], np.float32)
        for f in ((0, 1, 2), (0, 2, 3)):
            tri_v.append(q[list(f)])
            uvs.append(quad_uv[list(f)])
    return np.asarray(tri_v, np.float32), np.asarray(uvs, np.float32)


def _card_masks(uvs, pool_cls=TexturePool, build=build_tri_alpha_masks):
    pool = pool_cls()
    tid = pool.add_image(_leaf_tex())
    return build(uvs, np.zeros(len(uvs), np.int64), pool, [2], [0.5],
                 [[tid, -1, -1, -1, -1]])


def test_torch_trace2_mask_table_rides_in_slot_order():
    tri_v, uvs = _alpha_cards(40, 150)
    masks = _card_masks(uvs)
    ta, k2 = trace2.build_tri_blocks2(tri_v, tri_mask=masks)
    s2t = ta["pk_slot2tri"]
    pm = ta["pk_mask"]
    assert pm.dtype == np.int32 and pm.shape == (len(s2t), 8)
    np.testing.assert_array_equal(pm[s2t >= 0, :7], masks[s2t[s2t >= 0]])
    assert not pm[s2t < 0].any() and not pm[:, 7].any()
    # the same words, in the same slots, as the JAX tables' mask rows
    jm = _card_masks(uvs, JPool, j_masks)
    ja, jk2 = j_build(tri_v, tri_mask=jm)
    m1, w = ja["pk_l1_base"].shape[0], 16 * jk2 + 128
    jrows = ja["pk_tri"].reshape(16, m1, w)[9:16, :, :16 * jk2]
    np.testing.assert_array_equal(pm[:, :7].T,
                                  jrows.reshape(7, -1).view(np.int32))
    with pytest.raises(ValueError):
        trace2.build_tri_blocks2(tri_v, tri_mask=masks.view(np.float32))


@pytest.mark.parametrize("amask", [1, 2])
def test_torch_trace2_amask_plain_matches_pallas_kernel(amask):
    """The alpha micro-mask modes against the JAX kernel (interpret mode)
    on 500 alpha-card triangles.  Mode 1 is order-independent in both:
    valid and tri equal, t to rtol=1e-5.  In mode 2 the JAX kernel's
    `solid` depends on its visit order (it collapses on an opaque-cell hit
    below its CURRENT best mixed t), the port's does not (solid iff the
    nearest opaque-cell hit is nearer than every mixed one), so exactly
    these relations hold: the same miss lanes; every port-solid lane is
    JAX-solid; every JAX-solid lane is solid or a candidate in the port."""
    tri_v, uvs = _alpha_cards(41, 250)
    jm = _card_masks(uvs, JPool, j_masks)
    tm = _card_masks(uvs)
    ja, jk2 = j_build(tri_v, tri_mask=jm)
    ta, _ = trace2.build_tri_blocks2(tri_v, tri_mask=tm)
    o, d = _rays(42, 256)
    t_max = np.full((256,), BIG_F32, np.float32)
    t_max[::7] = 11.0
    got_j = pallas_tri_intersect2({k: jnp.asarray(v) for k, v in ja.items()},
                                  jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(t_max), jk2, amask=amask)
    got_t = trace2.tri_intersect2(_port_tables(ta), torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  torch.from_numpy(t_max), amask=amask)
    vj, vt = np.asarray(got_j["valid"]), got_t["valid"].numpy()
    plain0 = trace2.tri_intersect2(_port_tables(ta), torch.from_numpy(o),
                                   torch.from_numpy(d),
                                   torch.from_numpy(t_max))
    if amask == 1:
        assert "solid" not in got_t
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(got_t["tri"].numpy()[vj],
                                      np.asarray(got_j["tri"])[vj])
        np.testing.assert_allclose(got_t["t"].numpy()[vj],
                                   np.asarray(got_j["t"])[vj], rtol=1e-5)
        # the cull really drops some hits of the unmasked pass
        assert 20 < vt.sum() < plain0["valid"].numpy().sum()
        return
    sj, st = np.asarray(got_j["solid"]), got_t["solid"].numpy()
    assert st.sum() > 10, "solid never fires"
    assert (vt & ~st).sum() > 10, "no mixed candidate"
    np.testing.assert_array_equal(~vt & ~st, ~vj & ~sj)      # miss lanes
    assert not (st & ~sj).any()           # port-solid => JAX-solid
    assert not (sj & ~(st | vt)).any()    # JAX-solid => solid or candidate
    assert not (st & vt).any() and not (sj & vj).any()
    # where both report a candidate and JAX did not collapse, it is the
    # same nearest mixed hit
    both = vt & vj
    np.testing.assert_array_equal(got_t["tri"].numpy()[both],
                                  np.asarray(got_j["tri"])[both])
    assert (got_t["t"].numpy()[st] == BIG_F32).all()
    assert (got_t["tri"].numpy()[st] == -1).all()


def test_torch_trace2_amask_refuses_any_hit_and_maskless_tables():
    tri_v, uvs = _alpha_cards(43, 20)
    ta, _ = trace2.build_tri_blocks2(tri_v, tri_mask=_card_masks(uvs))
    o, d = _rays(2, 8)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    for fn in (trace2.tri_intersect2, trace2.tri_intersect2_plain):
        with pytest.raises(ValueError, match="mutually exclusive"):
            fn(_port_tables(ta), o, d, BIG_F32, any_hit=True, amask=1)
        with pytest.raises(ValueError, match="amask must be"):
            fn(_port_tables(ta), o, d, BIG_F32, amask=3)
        tb, _ = trace2.build_tri_blocks2(tri_v)
        with pytest.raises(ValueError, match="pk_mask"):
            fn(_port_tables(tb), o, d, BIG_F32, amask=2)


@pytest.mark.parametrize("amask", [1, 2])
def test_torch_trace2_amask_pruned_plain_equals_brute(amask):
    tri_v, uvs = _alpha_cards(44, 2000, spread=10.0)
    ta, _ = trace2.build_tri_blocks2(tri_v, tri_mask=_card_masks(uvs), g=32)
    tabs = _port_tables(ta)
    o, d = _rays(45, 400, spread=10.0)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((400,), BIG_F32)
    t_max[::4] = 18.0
    pruned = trace2.tri_intersect2_plain(tabs, o, d, t_max, amask=amask)
    brute = trace2.tri_intersect2_plain(tabs, o, d, t_max, amask=amask,
                                        prune=False)
    assert 50 < int(brute["valid"].sum()) < 400
    for k in brute:
        assert torch.equal(pruned[k], brute[k]), k


def _mixed_scene(seed=21):
    """A 2000-tri soup plus spheres and quads, as numpy tables."""
    tri_v = _soup(seed, 2000)
    rng = np.random.default_rng(seed)
    sph_c = rng.uniform(-5, 5, (3, 3)).astype(np.float32)
    sph_r = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    q = np.asarray([[-8, -7, -8], [-8, 7, -8]], np.float32)
    u = np.asarray([[16, 0, 0], [16, 0, 0]], np.float32)
    vv = np.asarray([[0, 0, 16], [0, 0, 16]], np.float32)
    raw = np.cross(u, vv)
    l2 = (raw * raw).sum(-1, keepdims=True)
    n = (raw / np.sqrt(l2)).astype(np.float32)
    return dict(tri_v=tri_v, sph_c=sph_c, sph_r=sph_r, quad_q=q, quad_u=u,
                quad_v=vv, quad_n=n, quad_d=(n * q).sum(-1).astype(np.float32),
                quad_w=(raw / l2).astype(np.float32),
                scene_lo=np.full(3, -8, np.float32),
                scene_hi=np.full(3, 8, np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_torch_pallas_dispatch_matches_brute(any_hit):
    """_pallas_dispatch (sort by _first_block_key, dead lanes last,
    padding, analytic merge) == the brute scan of the same scene."""
    sc = _mixed_scene()
    ta, k2 = trace2.build_tri_blocks2(sc["tri_v"])
    scene = _port_tables({**sc, **ta})
    meta = SceneMeta(n_tri=2000, n_sph=3, n_quad=2, accel="pallas",
                     block_k=k2, block_g=16)
    o, d = _rays(22, 300, spread=7.0)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((300,), BIG_F32)
    t_max[::5] = 0.0                           # dead lanes
    brute = tisect._intersect(scene, dataclasses.replace(meta,
                                                         accel="brute"),
                              o, d, t_max)
    if any_hit:
        occ = tisect._occluded(scene, meta, o, d, t_max)
        ref = tisect._occluded(scene, dataclasses.replace(meta,
                                                          accel="brute"),
                               o, d, t_max)
        np.testing.assert_array_equal(occ.numpy(), ref.numpy())
        return
    got = tisect._pallas_dispatch(scene, meta, o, d, t_max)
    v = brute["valid"].numpy()
    assert 50 < v.sum()
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    for k in ("kind", "idx"):
        np.testing.assert_array_equal(got[k].numpy()[v], brute[k].numpy()[v])
    np.testing.assert_allclose(got["t"].numpy()[v], brute["t"].numpy()[v],
                               rtol=1e-6)


def test_torch_first_block_key_matches_jax():
    rng = np.random.default_rng(5)
    m = 700                               # several 512-box chunks
    lo = rng.uniform(-50, 50, (m, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 4.0, (m, 3)).astype(np.float32)
    o = rng.uniform(-60, 60, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d[::9, 1] = 0.0                       # axis-parallel components
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kj = jisect._first_block_key(dict(pk_blk_lo=jnp.asarray(lo),
                                      pk_blk_hi=jnp.asarray(hi)),
                                 jnp.asarray(o), jnp.asarray(d))
    kt = tisect._first_block_key(dict(pk_blk_lo=torch.from_numpy(lo),
                                      pk_blk_hi=torch.from_numpy(hi)),
                                 torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))


@pytest.mark.parametrize("m", [300, 700])
def test_torch_first_block_key_hier_matches_jax(monkeypatch, m):
    """PT_HIER_KEY=1: the hierarchical key (top-2 coarse groups refined
    jointly) equals the JAX package's bit for bit on tables of more than
    64 top-level boxes, and differs from the flat key on some rays."""
    from pathtracing_tpu_torch.accel.build import sort_key_coarse
    rng = np.random.default_rng(m)
    lo = np.sort(rng.uniform(-50, 50, (m, 3)).astype(np.float32), axis=0)
    hi = lo + rng.uniform(0.5, 6.0, (m, 3)).astype(np.float32)
    o = rng.uniform(-60, 60, (500, 3)).astype(np.float32)
    d = lo[rng.integers(0, m, 500)] + 1.0 - o      # aimed into the boxes
    d[::9, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tabs = dict(pk_blk_lo=lo, pk_blk_hi=hi, **sort_key_coarse(lo, hi))
    jt = {k: jnp.asarray(v) for k, v in tabs.items()}
    tt = {k: torch.from_numpy(v) for k, v in tabs.items()}
    flat = tisect._first_block_key(tt, torch.from_numpy(o),
                                   torch.from_numpy(d))
    monkeypatch.setenv("PT_HIER_KEY", "1")
    kj = jisect._first_block_key(jt, jnp.asarray(o), jnp.asarray(d))
    kt = tisect._first_block_key(tt, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
    assert (kt != flat).any() and (kt < 0x7FFFFFFE).sum() > 100


def test_torch_kernel_wrapper_refuses_cpu_counters():
    ta, _ = trace2.build_tri_blocks2(_soup(1, 200))
    o, d = _rays(2, 8)
    with pytest.raises(ValueError):
        trace2.tri_intersect2(_port_tables(ta), torch.from_numpy(o),
                              torch.from_numpy(d), BIG_F32, counters=True)


@pytest.mark.cuda
def test_torch_trace2_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace2 kernel has no CPU mode")
    tri_v = _soup(13, 20000)
    ta, _ = trace2.build_tri_blocks2(tri_v)
    scene = {k: v.cuda() for k, v in _port_tables(ta).items()}
    o, d = _rays(14, 4096)
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    for any_hit in (False, True):
        got = trace2.tri_intersect2(scene, o, d, BIG_F32, any_hit=any_hit)
        ref = trace2.tri_intersect2_plain(scene, o, d, BIG_F32, prune=False)
        torch.cuda.synchronize()
        assert torch.equal(got["valid"], ref["valid"])
        if not any_hit:
            assert torch.equal(got["tri"], ref["tri"])
            assert torch.equal(got["t"], ref["t"])
    tri_v, uvs = _alpha_cards(44, 5000, spread=10.0)
    ta, _ = trace2.build_tri_blocks2(tri_v, tri_mask=_card_masks(uvs), g=32)
    scene = {k: v.cuda() for k, v in _port_tables(ta).items()}
    for amask in (1, 2):
        got = trace2.tri_intersect2(scene, o, d, BIG_F32, amask=amask)
        ref = trace2.tri_intersect2_plain(scene, o, d, BIG_F32, prune=False,
                                          amask=amask)
        torch.cuda.synchronize()
        for k in ref:
            assert torch.equal(got[k], ref[k]), (amask, k)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/trace2.cu compiled as plain C++ (one loop iteration per CUDA
    thread, no FMA contraction), so the kernel's traversal logic runs on
    the CPU: the card's compiler is not available here."""
    import shutil
    from pathtracing_tpu_torch.accel import cubuild
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    lib = trace2.bind(cubuild.host_library(
        "trace2", tmp_path_factory.mktemp("trace2_host")))

    def run(tabs, o, d, t_max, any_hit, amask=0):
        t, key, _ = trace2._launch_kernel(
            _port_tables(tabs), torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(np.ascontiguousarray(t_max, np.float32)),
            any_hit, False, amask, host_lib=lib)
        return t.numpy(), key.numpy()
    return run


@pytest.mark.parametrize("n_tri,g", [(3000, 16), (100000, 32)])
def test_torch_trace2_kernel_source_matches_plain(host_kernel, n_tri, g):
    """The CUDA kernel's traversal (front-to-back L1 buffer with rescans,
    child drain, leaf test, any-hit exit) equals the plain version: same
    slots, bit-equal t."""
    tri_v = _soup(31, n_tri) * np.float32(3.0 if n_tri > 10000 else 1.0)
    ta, _ = trace2.build_tri_blocks2(tri_v, g=g)
    o, d = _rays(32, 500, spread=18.0 if n_tri > 10000 else 6.0)
    t_max = np.full((500,), BIG_F32, np.float32)
    t_max[::3] = 12.0
    pt, ps = trace2._plain_slots(_port_tables(ta), torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(t_max))
    ht, hs = host_kernel(ta, o, d, t_max, False)
    assert (ps >= 0).sum() > 100
    np.testing.assert_array_equal(hs, ps.numpy())
    np.testing.assert_array_equal(ht, pt.numpy())
    _, hs_any = host_kernel(ta, o, d, t_max, True)
    np.testing.assert_array_equal(hs_any >= 0, ps.numpy() >= 0)


@pytest.mark.parametrize("amask", [1, 2])
@pytest.mark.parametrize("n_cards,g", [(1500, 16), (40000, 32)])
def test_torch_trace2_kernel_source_matches_plain_amask(host_kernel, n_cards,
                                                        g, amask):
    """The CUDA kernel's alpha micro-mask modes (the cell lookup, the
    mode-1 cull, the mode-2 order-independent solid rule with its
    min(t_mix, t_opq) box culling) equal the plain version exactly:
    same slots (-2 = solid), bit-equal t."""
    big = n_cards > 10000
    tri_v, uvs = _alpha_cards(51, n_cards, spread=18.0 if big else 6.0,
                              size=(0.6, 1.6) if big else (1.0, 2.5))
    ta, _ = trace2.build_tri_blocks2(tri_v, tri_mask=_card_masks(uvs), g=g)
    o, d = _rays(52, 500, spread=18.0 if big else 6.0)
    t_max = np.full((500,), BIG_F32, np.float32)
    t_max[::3] = 14.0
    pt, ps = trace2._plain_slots(_port_tables(ta), torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(t_max),
                                 amask=amask)
    ht, hs = host_kernel(ta, o, d, t_max, False, amask)
    assert (ps >= 0).sum() > 50
    if amask == 2:
        assert (ps == -2).sum() > 50
    np.testing.assert_array_equal(hs, ps.numpy())
    np.testing.assert_array_equal(ht, pt.numpy())
