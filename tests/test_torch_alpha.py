"""Alpha foliage in pathtracing_tpu_torch against the JAX package: the
micro-mask rows, the shadow predicate's restart chain (split tables,
whole-scene form, MASK and BLEND, tail compaction), the masked closest
pass and the interaction functions the chain uses.

The JAX side runs its accel="brute" path here: its alpha kernels in
interpret mode take minutes at this size (tests/test_alphamask.py marks
them slow); the kernel itself is held to the JAX kernel, at 500
triangles, in tests/test_torch_trace2.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.scene import alphamask as jmask
from pathtracing_tpu.scene import builder as jbuilder
from pathtracing_tpu.scene import intersect as jisect
from pathtracing_tpu.scene import textures as jtex
from pathtracing_tpu_torch.scene import alphamask as tmask
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene import textures as ttex
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _leaf_tex(k=64):
    u, v = np.meshgrid((np.arange(k) + 0.5) / k, (np.arange(k) + 0.5) / k)
    leaf = np.zeros((k, k, 4), np.float32)
    leaf[..., 1] = 0.5
    leaf[..., 3] = ((((u - 0.5) / 0.38) ** 2
                     + ((v - 0.5) / 0.47) ** 2) < 1.0).astype(np.float32)
    return leaf


# ---------------------------------------------------------------------------
# Mask rows
# ---------------------------------------------------------------------------

def _mask_inputs():
    rng = np.random.default_rng(0)
    uvs = np.concatenate([
        np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                 np.float32),
        (rng.random((30, 3, 2)) * 1.4 - 0.2).astype(np.float32)], 0)
    return _leaf_tex(64), uvs


@pytest.mark.parametrize("mode", [2, 1])
def test_torch_alpha_mask_rows_bit_equal_to_jax(mode):
    leaf, uvs = _mask_inputs()
    n = len(uvs)
    rows = []
    for texmod, maskmod in ((jtex, jmask), (ttex, tmask)):
        pool = texmod.TexturePool()
        tid = pool.add_image(leaf)
        solid = pool.add_solid((1.0, 1.0, 1.0))
        # material 0: the leaf's alpha channel; 1: a constant-opaque source;
        # 2: a dedicated alpha texture (red channel of the leaf image)
        mats = np.arange(n) % 3
        rows.append(maskmod.build_tri_alpha_masks(
            uvs, mats, pool, [mode] * 3, [0.5, 0.5, 0.05],
            [[tid, -1, -1, -1, -1], [solid, -1, -1, -1, -1],
             [-1, -1, -1, -1, tid]]))
    want, got = rows
    assert tmask.MASK_ROWS == jmask.MASK_ROWS == 7
    assert got.dtype == np.int32 and got.shape == (n, 7)
    np.testing.assert_array_equal(got, np.asarray(want).view(np.int32))


def _bilinear_alpha(plane, tx, ty):
    k_h, k_w = plane.shape
    x = tx * k_w - 0.5
    y = ty * k_h - 0.5
    xi = np.floor(x).astype(int)
    yi = np.floor(y).astype(int)
    dx = x - xi
    dy = y - yi

    def f(xx, yy):
        return plane[np.mod(yy, k_h), np.mod(xx, k_w)]

    return ((1 - dx) * (1 - dy) * f(xi, yi) + dx * (1 - dy) * f(xi + 1, yi)
            + (1 - dx) * dy * f(xi, yi + 1) + dx * dy * f(xi + 1, yi + 1))


def test_torch_alpha_mask_classifier_conservative():
    """No opaque cell holds a failing point and no transparent cell a
    passing one, through the plain version's own cell lookup."""
    from pathtracing_tpu_torch.accel.trace2 import _alpha_cell_bits
    leaf, uvs = _mask_inputs()
    n = len(uvs)
    pool = ttex.TexturePool()
    tid = pool.add_image(leaf)
    rows = tmask.build_tri_alpha_masks(uvs, np.zeros(n, np.int64), pool,
                                       [2], [0.5], [[tid, -1, -1, -1, -1]])
    S = 64
    uu, vv = np.meshgrid((np.arange(S) + 0.5) / S, (np.arange(S) + 0.5) / S)
    m = uu + vv <= 1.0
    uu, vv = uu[m].astype(np.float32), vv[m].astype(np.float32)
    k = len(uu)
    words = torch.from_numpy(np.pad(rows, ((0, 0), (0, 1))))
    opq, mix = _alpha_cell_bits(
        words[:, None, :].expand(n, k, 8),
        torch.from_numpy(uu)[None].expand(n, k),
        torch.from_numpy(vv)[None].expand(n, k))
    opq, mix = opq.numpy(), mix.numpy()
    uv0, uv1, uv2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
    tx = (uv0[:, :1] + uu[None] * (uv1[:, :1] - uv0[:, :1])
          + vv[None] * (uv2[:, :1] - uv0[:, :1]))
    ty = (uv0[:, 1:] + uu[None] * (uv1[:, 1:] - uv0[:, 1:])
          + vv[None] * (uv2[:, 1:] - uv0[:, 1:]))
    solid = _bilinear_alpha(leaf[..., 3], tx, ty) > 0.5
    assert not (opq & ~solid).any()
    assert not (~opq & ~mix & solid).any()
    # the masks resolve a useful fraction (not all mixed)
    assert (opq | (~opq & ~mix)).mean() > 0.3


# ---------------------------------------------------------------------------
# The card scene: an opaque floor grid with alpha-cutout cards over it
# ---------------------------------------------------------------------------

def _card_scene(mod, blend=False, cards=60, grid=20, **build_kw):
    rng = np.random.default_rng(7)
    b = mod.SceneBuilder()
    tid = b.textures.add_image(_leaf_tex(64))
    leaf_mat = b.add_diffuse((0.3, 0.6, 0.3), base_tex=tid,
                             alpha_mode=1 if blend else 2, alpha_cutoff=0.5)
    opaque_mat = b.add_diffuse((0.7, 0.7, 0.7))
    gx, gz = np.meshgrid(np.linspace(-10, 10, grid + 1),
                         np.linspace(-10, 10, grid + 1))
    V, F = [], []
    for i in range(grid):
        for j in range(grid):
            i0 = len(V)
            V += [[gx[i, j], 0, gz[i, j]], [gx[i, j + 1], 0, gz[i, j + 1]],
                  [gx[i + 1, j + 1], 0, gz[i + 1, j + 1]],
                  [gx[i + 1, j], 0, gz[i + 1, j]]]
            F += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    b.add_mesh(np.asarray(V, np.float32), np.asarray(F, np.int32),
               material=opaque_mat)
    for _ in range(cards):
        c = np.array([rng.uniform(-8, 8), rng.uniform(0.5, 4),
                      rng.uniform(-8, 8)])
        s = rng.uniform(1.5, 3.5)
        ry = rng.uniform(0, np.pi)
        ux = np.array([np.cos(ry), 0, np.sin(ry)]) * s
        uy = np.array([0, 1.0, 0]) * s
        V2 = np.array([c - 0.5 * ux, c + 0.5 * ux, c + 0.5 * ux + uy,
                       c - 0.5 * ux + uy], np.float32)
        b.add_mesh(V2, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                   uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                   material=leaf_mat)
    b.add_quad([-1, 8, -1], [2, 0, 0], [0, 0, 2], emission=(10, 10, 10))
    b.set_camera([0, 3, -12], [0, 1, 0], math.radians(45), (64, 48))
    return b.build(**build_kw)


def _rays(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-9, 9, n), rng.uniform(0.1, 5, n),
                  rng.uniform(-9, 9, n)], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full((n,), 12.0, np.float32)


@pytest.fixture(scope="module")
def card_scenes():
    """The card scene: the JAX brute build, the port's brute build and its
    split tables, forced onto the two-level kernel with TWOLEVEL_MIN = 0
    (920 triangles would go to the single-level one, which has its own
    tests in test_torch_trace1.py)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    try:
        out = dict(
            jax=_card_scene(jbuilder, accel="brute"),
            split=_card_scene(tbuilder, accel="pallas", device="cpu"),
            brute=_card_scene(tbuilder, accel="brute", device="cpu"),
            split_blend=_card_scene(tbuilder, blend=True, accel="pallas",
                                    device="cpu"))
    finally:
        mp.undo()
    assert "pk_l1_base" in out["split"][0] and "pka_l1_base" in out["split"][0]
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_torch_alpha_split_tables_built(card_scenes):
    scene, _, meta = card_scenes["split"]
    assert meta.accel == "pallas" and meta.has_alpha and meta.alpha_cull_mask
    assert meta.alpha_block_k > 0 and not meta.analytic_alpha
    n_alpha = 120
    s2t = scene["pka_slot2tri"].numpy()
    ids = np.sort(s2t[s2t >= 0])
    # the alpha table names exactly the card triangles, by global id
    np.testing.assert_array_equal(ids, np.arange(800, 800 + n_alpha))
    s2t_o = scene["pk_slot2tri"].numpy()
    np.testing.assert_array_equal(np.sort(s2t_o[s2t_o >= 0]), np.arange(800))
    # mask words ride in slot order, zero on padded slots
    mask = scene["pka_mask"].numpy()
    assert mask.dtype == np.int32 and mask.shape == (len(s2t), 8)
    assert not mask[s2t < 0].any() and mask[s2t >= 0, :3].any()
    _, _, meta_b = card_scenes["brute"]
    assert meta_b.accel == "brute" and not meta_b.alpha_cull_mask


@pytest.mark.parametrize("per_lane_key", [False, True])
def test_torch_occluded_mask_mode_equals_jax_brute(card_scenes, per_lane_key):
    """MASK-mode occlusion is deterministic: the port's split-table
    predicate (masks in the traversal, compacted tail) == the port's
    whole-scene chain == the JAX package's, lane for lane."""
    js, _, jm = card_scenes["jax"]
    o, d, tm = _rays()
    n = len(o)
    if per_lane_key:
        jkey = jnp.arange(n, dtype=jnp.uint32)
        tkey = torch.arange(n, dtype=torch.int64)
    else:
        jkey = tkey = 5
    want = np.asarray(jisect.occluded(js, jm, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tm), rand_key=jkey))
    assert 0.2 < want.mean() < 0.9
    for name in ("split", "brute"):
        scene, _, meta = card_scenes[name]
        got = tisect.occluded(scene, meta, *_t(o, d, tm), rand_key=tkey,
                              device="cpu").numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_torch_occluded_solid_resolves_in_the_traversal(card_scenes):
    """The amask=2 dispatch resolves a real share of the lanes in the
    traversal, and every such lane is occluded."""
    scene, _, meta = card_scenes["split"]
    o, d, tm = _t(*_rays())
    h = tisect._pallas_dispatch(scene, meta, o, d, tm, tri_tables="alpha",
                                analytic=False, alpha_shadow=True)
    occ = tisect.occluded(scene, meta, o, d, tm, device="cpu")
    assert h["solid"].any()
    assert not (h["solid"] & h["valid"]).any()
    assert (h["solid"] & occ).sum() == h["solid"].sum()
    stats = {}
    tisect._occluded(scene, meta, o, d, tm, stats=stats)
    assert stats["calls"] == 1 and 1 <= stats["restarts"] <= 64


def test_torch_occluded_blend_equals_jax_full_width_loop(card_scenes):
    """BLEND: the random number is keyed on (lane, restart, rand_key), so
    the port's whole-scene chain equals the JAX package's lane for lane
    (n < 4096: the JAX package runs its full-width loop)."""
    js, _, jm = card_scenes["jax"]
    js = dict(js, mat_alpha_mode=jnp.where(js["mat_alpha_mode"] == 2, 1,
                                           js["mat_alpha_mode"]))
    scene, _, meta = card_scenes["brute"]
    scene = dict(scene, mat_alpha_mode=torch.where(
        scene["mat_alpha_mode"] == 2, 1, scene["mat_alpha_mode"]))
    o, d, tm = _rays(2048)
    mask_mode = tisect.occluded(card_scenes["brute"][0], meta, *_t(o, d, tm),
                                device="cpu").numpy()
    for key in (0, 9):
        want = np.asarray(jisect.occluded(js, jm, jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(tm),
                                          rand_key=key))
        got = tisect.occluded(scene, meta, *_t(o, d, tm), rand_key=key,
                              device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert (got != mask_mode).any()      # BLEND really is stochastic


@pytest.mark.parametrize("which", ["split_blend", "split", "brute"])
def test_torch_occluded_compacted_tail_equals_full_width(card_scenes, which):
    """n >= 4096: gathering the live lanes after each restart changes no
    lane, in BLEND mode (lane-keyed random numbers) or MASK mode."""
    scene, _, meta = card_scenes[which]
    o, d, tm = _t(*_rays(4608, seed=8))
    key = torch.arange(4608, dtype=torch.int64) * 7
    full = tisect._occluded(scene, meta, o, d, tm, rand_key=key,
                            compact=False)
    st = {}
    comp = tisect._occluded(scene, meta, o, d, tm, rand_key=key, stats=st)
    assert st["restarts"] >= 2
    assert torch.equal(full, comp)
    assert 0.2 < float(full.float().mean()) < 0.9


def test_torch_masked_closest_pass_consistent(card_scenes):
    """The masked closest pass (accel="pallas", amask=1) drops only
    definitely-transparent hits of the unmasked one (accel="brute")."""
    scene1, _, meta1 = card_scenes["split"]
    scene0, _, meta0 = card_scenes["brute"]
    o, d, tm = _t(*_rays())
    h1 = tisect.intersect(scene1, meta1, o, d, tm, device="cpu")
    h0 = tisect.intersect(scene0, meta0, o, d, tm, device="cpu")
    t1, t0 = h1["t"].numpy(), h0["t"].numpy()
    v1, v0 = h1["valid"].numpy(), h0["valid"].numpy()
    # masked is a filtered view: it finds nothing the unmasked pass misses
    assert not (v1 & ~v0).any()
    assert not (v1 & v0 & (t0 > t1 + 1e-4)).any()
    assert v1.sum() < v0.sum()               # some hits really are culled
    # unmasked hits whose exact alpha test passes survive at the same t
    inter = tisect.make_interaction(scene0, meta0, o, d, h0, lite=True)
    mid = torch.clamp(inter["mat_id"], min=0)
    mode = scene0["mat_alpha_mode"][mid].numpy()
    a = ttex.texture_alpha(scene0, scene0["mat_tex"][mid, 0],
                           inter["uv"]).numpy()
    cut = scene0["mat_alpha_cutoff"][mid].numpy()
    keep = v0 & ((mode != 2) | (a > cut))
    assert v1[keep].all(), "masked pass dropped an exactly-solid hit"
    np.testing.assert_allclose(t1[keep], t0[keep], rtol=1e-5)
    same = keep & (h0["kind"].numpy() == 0)
    np.testing.assert_array_equal(h1["idx"].numpy()[same],
                                  h0["idx"].numpy()[same])


# ---------------------------------------------------------------------------
# Interaction: authored tangents, normal map, the chain's subset
# ---------------------------------------------------------------------------

def _tangent_scene(mod, **build_kw):
    rng = np.random.default_rng(12)
    b = mod.SceneBuilder()
    nimg = rng.random((16, 16, 3)).astype(np.float32) * 0.5 + 0.5
    ntex = b.textures.add_image(nimg)
    btex = b.textures.add_image(rng.random((8, 8, 4)).astype(np.float32))
    mapped = b.add_diffuse((0.8, 0.7, 0.6), base_tex=btex, norm_tex=ntex)
    plain = b.add_diffuse((0.5, 0.5, 0.5))
    nv = 40
    V = rng.uniform(-3, 3, (nv, 3)).astype(np.float32)
    F = rng.integers(0, nv, (70, 3)).astype(np.int32)
    F = F[(F[:, 0] != F[:, 1]) & (F[:, 1] != F[:, 2]) & (F[:, 0] != F[:, 2])]
    N = rng.normal(size=(nv, 3)).astype(np.float32)
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    T = rng.normal(size=(nv, 3)).astype(np.float32)
    UV = rng.uniform(-1, 2, (nv, 2)).astype(np.float32)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = [[1.1, 0.2, 0.0], [0.0, 0.9, 0.1], [0.1, 0.0, 1.2]]
    tf[:3, 3] = [0.3, -0.2, 0.1]
    b.add_mesh(V, F[:35], normals=N, uvs=UV, tangents=T, material=mapped,
               transform=tf)
    b.add_mesh(V, F[35:], uvs=UV, material=plain)       # no tangents
    b.add_sphere([0, 0, -4.5], 1.0, material=mapped)
    b.add_quad([-4, -3.5, -4], [8, 0, 0], [0, 0, 8], material=mapped)
    b.add_uniform_inf_light((1, 1, 1))
    b.set_camera([0, 0, -9], [0, 0, 0], math.radians(40), (8, 8))
    return b.build(accel="brute", **build_kw)


@pytest.mark.parametrize("fn", ["make_interaction", "make_interaction_lite",
                                "_chain_interaction"])
def test_torch_interaction_with_tangents_and_normal_map_matches_jax(fn):
    """Against the JAX functions as the render runs them, compiled: the
    port rounds the barycentric sums as that code's fused multiply-adds
    (intersect._tri_barycentrics), so the interpolated uv agree to an ulp
    even where they are large."""
    js, _, jm = _tangent_scene(jbuilder)
    ts, _, tm_ = _tangent_scene(tbuilder, device="cpu")
    assert tm_.has_tangents and tm_.has_normal_maps
    assert tm_.has_tangents == jm.has_tangents
    assert tm_.mat_tex_present == jm.mat_tex_present
    for k in ("tri_tan", "tri_pack", "mat_tex", "tri_prop"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
    rng = np.random.default_rng(13)
    n = 600
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 8.0
    d = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    hit = jisect.intersect(js, jm, jnp.asarray(o), jnp.asarray(d), 3e38)
    hit_t = {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.asarray(v).dtype == np.int32 else np.asarray(v).dtype))
        for k, v in hit.items()}
    kinds = np.asarray(hit["kind"])
    if fn == "_chain_interaction":
        # triangle hits only: the chain uses it when no analytic prim
        # carries an alpha material
        tri_only = kinds == 0
        hit = {k: jnp.where(tri_only, v, dict(t=3e38, kind=-1, idx=0,
                                              valid=False)[k])
               for k, v in hit.items()}
        hit_t = {k: torch.where(torch.from_numpy(tri_only), v,
                                dict(t=3e38, kind=-1, idx=0, valid=False)[k])
                 for k, v in hit_t.items()}
        want = jax.jit(lambda o_, d_, h_: jisect._chain_interaction(
            js, jm, o_, d_, h_))(jnp.asarray(o), jnp.asarray(d), hit)
        got = tisect._chain_interaction(ts, tm_, *_t(o, d), hit_t)
        assert tri_only.sum() > 100
    else:
        lite = fn.endswith("lite")
        want = jax.jit(lambda o_, d_, h_: jisect.make_interaction(
            js, jm, o_, d_, h_, lite=lite))(jnp.asarray(o), jnp.asarray(d),
                                            hit)
        got = tisect.make_interaction(ts, tm_, *_t(o, d), hit_t, lite=lite)
        assert set(np.unique(kinds)) >= {0, 1, 2}
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Builder: models, instances, refusals
# ---------------------------------------------------------------------------

def _quad_model():
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def test_torch_model_instances_flatten_like_jax():
    """runtime=False and runtime="auto" instances become the same world
    triangles, in the same order, as the JAX builder's."""
    scenes = []
    for mod, kw in ((jbuilder, {}), (tbuilder, dict(device="cpu"))):
        b = mod.SceneBuilder()
        m = b.add_diffuse((0.5, 0.5, 0.5))
        v, f = _quad_model()
        uv = v[:, :2].copy()
        mid = b.add_model(v, f, uvs=uv, material=m)
        assert b.add_model(v, f, uvs=uv, material=m) == mid    # dedup
        for k in range(3):
            tf = np.eye(4, dtype=np.float32)
            tf[:3, 3] = [k, 0.5 * k, -k]
            tf[0, 0] = 1.0 + 0.5 * k
            b.add_model_instance(mid, tf, runtime="auto" if k else False)
        b.add_mesh(v + 5.0, f, material=m)
        b.add_uniform_inf_light((1, 1, 1))
        b.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4))
        scenes.append(b.build(accel="brute", **kw))
    (js, _, jm), (ts, _, tm_) = scenes
    assert tm_.n_tri == jm.n_tri == 8 and tm_.n_inst == jm.n_inst == 0
    for k in ("tri_v", "tri_n", "tri_uv", "tri_prop"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)


def test_torch_unported_features_still_refused(monkeypatch):
    b = tbuilder.SceneBuilder()
    v, f = _quad_model()
    mid = b.add_model(v, f)
    # run-time instances, motion and media are ported: they build
    b.add_model_instance(mid, runtime=True)
    b.add_model_instance(mid, velocity=(1.0, 0.0, 0.0))
    b.add_mesh(v, f, velocity=(0.0, 1.0, 0.0))
    fog = b.add_medium((0.1,) * 3, (0.1,) * 3)
    b.add_sphere([0, 0, 0], 1.0, medium=fog)
    # environment-map and emissive-texture lights are ported as well
    b3 = tbuilder.SceneBuilder()
    tid = b3.textures.add_image(np.ones((2, 4, 3), np.float32))
    b3.add_env_light(tid)
    b3.add_quad([0, 0, 0], [1, 0, 0], [0, 1, 0], em_tex=tid)
    b3.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4))
    meta3 = b3.build(device="cpu")[2]
    assert meta3.n_env == 1 and meta3.has_emissive_tex and meta3.n_lights == 2
    # an emissive model under "auto" stays a run-time instance with its own
    # area lights, and so does an "auto" total above the flatten limit
    lamp = b.add_model(v, f, emission=(5.0, 5.0, 5.0))
    b.add_model_instance(lamp, runtime="auto")
    b.add_model_instance(mid, runtime="auto")
    b.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4), shutter=(0.0, 1.0))
    scene, _, meta = b.build(device="cpu")
    assert meta.n_inst == 2 and meta.has_motion      # mid's "auto" flattened
    assert meta.n_lights == len(f) and "ilight_map" in scene
    # accel="bvh" builds too, and on this moving, instanced scene it warns
    # and falls back to the brute scan as the JAX builder does
    with pytest.warns(UserWarning, match="accel='bvh' does not support"):
        assert b.build(accel="bvh", device="cpu")[2].accel == "brute"
    b2 = tbuilder.SceneBuilder()
    mid2 = b2.add_model(v, f)
    for _ in range(3):
        b2.add_model_instance(mid2, runtime="auto")
    b2.set_camera([0, 0, -5], [0, 0, 0], 0.8, (4, 4))
    monkeypatch.setattr(tbuilder, "FLATTEN_MAX", 2 * len(f))
    assert b2.build(device="cpu")[2].n_inst == 3
