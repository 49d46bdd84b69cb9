"""Run-time instancing in pathtracing_tpu_torch against the JAX package:
the two-level instanced tables and the traversal over them (closest,
any-hit, alpha micro-mask modes; pallas_tri_intersect2 in interpret
mode), the kernel source as host C++, intersect / occluded /
make_interaction on mixed world + instance scenes, per-instance area
lights, and renders (run-time instances, the San-Miguel analog with its
foliage kept as instances)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.accel import pallas_trace2 as jt2
from pathtracing_tpu.core.math import BIG_F32
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.scene import intersect as jisect
from pathtracing_tpu.scene.alphamask import build_tri_alpha_masks as j_masks
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu.scene.textures import TexturePool as JPool
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.accel import cubuild, trace2
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import intersect as tisect
from pathtracing_tpu_torch.scene.alphamask import build_tri_alpha_masks
from pathtracing_tpu_torch.scene.textures import TexturePool
from pathtracing_tpu_torch.scene.types import SHAPE_ITRI

from test_torch_trace1 import (_J, _T, _alpha_cards, _card_masks, _inst_args,
                               _rays, _same, _same_as_jax, _t3, _xf)
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _carry(scene, cam, meta):
    return convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)},
        device="cpu")


def _masked_inst_args(seed):
    """World alpha cards + one 96-triangle card model under sheared,
    non-uniformly scaled transforms, with int32 mask words for both
    packages: (args, port words (tri, otri), JAX words (tri, otri))."""
    rng = np.random.default_rng(seed)
    wv, wuv = _alpha_cards(seed + 1, 200)
    ov, ouv = _alpha_cards(seed + 2, 48, spread=1.0, size=(0.5, 1.2))
    fw = [_xf(rng) for _ in range(30)]
    iv = [np.linalg.inv(f).astype(np.float32) for f in fw]
    args = (wv, ov, [f[:3, :4] for f in fw], [f[:3, :4] for f in iv],
            [0] * 30, [96] * 30)
    port = (_card_masks(wuv), _card_masks(ouv))
    jax_ = (_card_masks(wuv, JPool, j_masks), _card_masks(ouv, JPool, j_masks))
    return args, port, jax_


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "subset", "motion"])
def test_torch_trace2_inst_tables_match_jax(variant):
    args = _inst_args(5)
    kw = {}
    if variant == "subset":
        rng = np.random.default_rng(1)
        kw = dict(tri_sel=rng.random(len(args[0])) < 0.4,
                  otri_sel=np.concatenate([np.zeros(96, bool),
                                           rng.random(200) < 0.5]))
    elif variant == "motion":
        rng = np.random.default_rng(2)
        kw = dict(tri_vel=rng.normal(0, .5, (len(args[0]), 3))
                  .astype(np.float32),
                  inst_vel=rng.normal(0, .5, (len(args[2]), 3))
                  .astype(np.float32), shutter=(0.0, 1.0))
    g = 4
    ta, tk2 = trace2.build_tri_blocks2_inst(*args, g=g, **kw)
    ja, jk2 = jt2.build_tri_blocks2_inst(*args, g=g, **kw)
    assert tk2 == jk2
    for k in ("pk_slot2tri", "pk_blk_src", "pk_blk_inst", "pk_l1_base"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    for k in ("pk_blk_lo", "pk_blk_hi", "pk_inst_inv", "pk_inst_velo"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-6, atol=1e-30,
                                   err_msg=k)
    if variant == "subset":     # the 96-triangle model emits no L1
        assert not np.isin(np.arange(25), ta["pk_blk_inst"]).any()
    # the same triangle rows and child boxes per physical slot / child
    m1p, w = len(ja["pk_l1_base"]), g * jk2 + 128
    jrow = ja["pk_tri"].reshape(16, m1p, w)
    data = ta["pk_slot2tri"] >= 0
    np.testing.assert_array_equal(
        ta["pk_tri"][data], jrow[:12, :, :g * jk2].reshape(12, -1).T[data])
    np.testing.assert_array_equal(
        ta["pk_l2box"][:, [0, 1, 2, 4, 5, 6]],
        jrow[:6, :, g * jk2:g * jk2 + g].reshape(6, -1).T)
    # expanded boxes never take a padded child's far point in
    assert np.abs(ta["pk_blk_hi"]).max() < 1e6


def test_torch_trace2_inst_mask_words_match_jax():
    args, (tm, om), (jtm, jom) = _masked_inst_args(20)
    ta, _ = trace2.build_tri_blocks2_inst(*args, g=4, tri_mask=tm,
                                          otri_mask=om)
    ja, jk2 = jt2.build_tri_blocks2_inst(*args, g=4, tri_mask=jtm,
                                         otri_mask=jom)
    m1p, w = len(ja["pk_l1_base"]), 4 * jk2 + 128
    jwords = np.ascontiguousarray(
        ja["pk_tri"].reshape(16, m1p, w)[9:16, :, :4 * jk2]
        .reshape(7, -1).T).view(np.int32)
    data = ta["pk_slot2tri"] >= 0
    np.testing.assert_array_equal(ta["pk_mask"][data, :7], jwords[data])
    assert not ta["pk_mask"][~data].any()


# ---------------------------------------------------------------------------
# The contract
# ---------------------------------------------------------------------------

def test_torch_trace2_inst_matches_pallas_kernel():
    """Instanced closest and any-hit against pallas_tri_intersect2
    (interpret mode): valid, tri, inst equal, t to rtol=1e-5; culled
    plain == brute plain exactly."""
    args = _inst_args(7)
    ta, k2 = trace2.build_tri_blocks2_inst(*args, g=4)
    ja, _ = jt2.build_tri_blocks2_inst(*args, g=4)
    o, d, t_max = _rays(32, 384)
    tabs = _T(ta)
    got = trace2.tri_intersect2(tabs, *_t3(o, d, t_max))
    _same(got, trace2.tri_intersect2_plain(tabs, *_t3(o, d, t_max),
                                           prune=False))
    assert int((got["inst"] >= 0).sum()) > 50
    assert int((got["valid"] & (got["inst"] < 0)).sum()) > 20
    want = jt2.pallas_tri_intersect2(_J(ja), jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), k2, g=4)
    _same_as_jax(got, want)
    anyh = jt2.pallas_tri_intersect2(_J(ja), jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), k2, g=4,
                                     any_hit=True)
    np.testing.assert_array_equal(np.asarray(anyh["valid"]),
                                  got["valid"].numpy())


@pytest.mark.parametrize("amask", [1, 2])
def test_torch_trace2_inst_amask_matches_pallas_kernel(amask):
    """Masks ride with the model: instanced mask modes under sheared,
    non-uniformly scaled instances against the JAX kernel (mode 1 exact,
    mode 2 by the four relations), and against the brute plain version
    exactly."""
    args, (tm, om), (jtm, jom) = _masked_inst_args(21)
    ta, k2 = trace2.build_tri_blocks2_inst(*args, g=4, tri_mask=tm,
                                           otri_mask=om)
    ja, _ = jt2.build_tri_blocks2_inst(*args, g=4, tri_mask=jtm,
                                       otri_mask=jom)
    o, d, t_max = _rays(33, 256)
    tabs = _T(ta)
    got = trace2.tri_intersect2(tabs, *_t3(o, d, t_max), amask=amask)
    brute = trace2.tri_intersect2_plain(tabs, *_t3(o, d, t_max), amask=amask,
                                        prune=False)
    for key in brute:
        assert torch.equal(got[key], brute[key]), key
    want = jt2.pallas_tri_intersect2(_J(ja), jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), k2, g=4, amask=amask)
    vj, vt = np.asarray(want["valid"]), got["valid"].numpy()
    if amask == 1:
        _same_as_jax(got, want)
        assert int((got["inst"] >= 0).sum()) > 20
        return
    sj, st = np.asarray(want["solid"]), got["solid"].numpy()
    assert st.sum() > 10 and (vt & ~st).sum() > 10
    np.testing.assert_array_equal(~vt & ~st, ~vj & ~sj)      # miss lanes
    assert not (st & ~sj).any()           # port-solid => JAX-solid
    assert not (sj & ~(st | vt)).any()    # JAX-solid => solid or candidate
    both = vt & vj
    np.testing.assert_array_equal(got["tri"].numpy()[both],
                                  np.asarray(want["tri"])[both])
    np.testing.assert_array_equal(got["inst"].numpy()[both],
                                  np.asarray(want["inst"])[both])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/trace2.cu compiled as plain C++: the kernel's logic on the
    CPU."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source as host code")
    return trace2.bind(cubuild.host_library(
        "trace2", tmp_path_factory.mktemp("trace2_host_inst")))


@pytest.mark.parametrize("mode", ["closest", "amask1", "amask2", "motion",
                                  "many_l1"])
def test_torch_trace2_inst_kernel_source_matches_plain(host_lib, mode):
    """The CUDA kernel's instanced modes (world-space L1 order, per-L1
    inverse transform, ties by expanded L1 then offset, moving instances)
    equal the plain version: the same keys, bit-equal t, 0 flips."""
    n = 500
    o, d, t_max = _rays(52, n)
    kw, amask = {}, 0
    if mode in ("amask1", "amask2"):
        args, (tm, om), _ = _masked_inst_args(22)
        ta, _ = trace2.build_tri_blocks2_inst(*args, g=4, tri_mask=tm,
                                              otri_mask=om)
        amask = int(mode[-1])
    else:
        args = _inst_args(11, n_inst=300 if mode == "many_l1" else 40)
        bkw = {}
        if mode == "motion":
            rng = np.random.default_rng(2)
            bkw = dict(tri_vel=rng.normal(0, .5, (len(args[0]), 3))
                       .astype(np.float32),
                       inst_vel=rng.normal(0, .5, (40, 3)).astype(np.float32),
                       shutter=(0.0, 1.0))
            kw = dict(time=torch.from_numpy(rng.uniform(0, 1, n)
                                            .astype(np.float32)))
        ta, _ = trace2.build_tri_blocks2_inst(*args, g=4, **bkw)
    tabs = _T(ta)
    pt, pk = trace2._plain_slots(tabs, *_t3(o, d, t_max), amask=amask, **kw)
    ht, hk, _ = trace2._launch_kernel(tabs, *_t3(o, d, t_max), False, False,
                                      amask, host_lib=host_lib, **kw)
    assert (pk >= 0).sum() > 50
    if amask == 2:
        assert (pk == -2).sum() > 20
    assert torch.equal(hk, pk) and torch.equal(ht, pt)
    if not amask:
        _, hk_any, _ = trace2._launch_kernel(
            tabs, *_t3(o, d, t_max), True, False, 0, host_lib=host_lib, **kw)
        assert torch.equal(hk_any >= 0, pk >= 0)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

_PV = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                  [0, 1.2, 0]], np.float32)
_PF = np.asarray([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                  [0, 2, 1], [0, 3, 2]], np.int32)


def _tf(tx, ty, tz, s=1.0, ry=0.0):
    c, si = math.cos(ry), math.sin(ry)
    return np.asarray([[c * s, 0, si * s, tx], [0, s, 0, ty],
                       [-si * s, 0, c * s, tz], [0, 0, 0, 1]], np.float32)


def _pyramids(B, runtime=True, world_mesh=True, floor=False, **build_kw):
    """Three instances of a little pyramid (+ world triangles, + a floor
    quad): the mixed world + instance scene."""
    b = B()
    mat = b.add_diffuse((0.7, 0.5, 0.3))
    mid = b.add_model(_PV, _PF, material=mat)
    for t in [_tf(-2, 0, 0), _tf(2, 0, 1, s=1.5, ry=0.7),
              _tf(0, 0, -2, s=0.7, ry=2.1)]:
        b.add_model_instance(mid, t, runtime=runtime)
    if world_mesh:
        b.add_mesh(_PV * 3.0 + np.asarray([0, 0, 5], np.float32), _PF,
                   material=mat)
    if floor:
        b.add_quad([-6, 0, -6], [12, 0, 0], [0, 0, 12],
                   material=b.add_diffuse((0.5, 0.5, 0.5)))
    b.add_uniform_inf_light((1, 1, 1))
    b.set_camera([0, 4, -7], [0, 0.5, 0], math.radians(40), (32, 32))
    return b.build(**build_kw)


def _scene_rays(seed, n=512):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4, n)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_torch_instanced_scene_intersect_matches_brute_and_jax():
    """intersect / occluded / make_interaction on the mixed world +
    instance scene: the port's traversal path (single-level instanced
    tables here) against its brute scan and both against the JAX package;
    valid, kind, idx equal, t to rtol=1e-4, atol=1e-5."""
    sp, _, mp = _pyramids(tbuilder.SceneBuilder, accel="pallas", device="cpu")
    sb, _, mb = _pyramids(tbuilder.SceneBuilder, accel="brute", device="cpu")
    js, _, jm = _pyramids(JBuilder, accel="pallas")
    assert mp.accel == "pallas" and "pk_blk_src" in sp \
        and "pk_l1_base" not in sp
    assert mp.n_inst == 3 and mp.n_obj_tri == 6
    o, d = _scene_rays(0)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hp = tisect.intersect(sp, mp, to, td, 1e30, device="cpu")
    hb = tisect.intersect(sb, mb, to, td, 1e30, device="cpu")
    hj = jisect.intersect(js, jm, jnp.asarray(o), jnp.asarray(d), 1e30)
    m = hb["valid"].numpy()
    assert (hb["kind"].numpy() == SHAPE_ITRI).sum() > 30
    for h in (hp, hb):
        np.testing.assert_array_equal(h["valid"].numpy(),
                                      np.asarray(hj["valid"]))
        for k in ("kind", "idx"):
            np.testing.assert_array_equal(h[k].numpy()[m],
                                          np.asarray(hj[k])[m])
        np.testing.assert_allclose(h["t"].numpy()[m], np.asarray(hj["t"])[m],
                                   rtol=1e-4, atol=1e-5)
    tm6 = torch.full((len(o),), 6.0)
    oj = np.asarray(jisect.occluded(js, jm, jnp.asarray(o), jnp.asarray(d),
                                    jnp.full((len(o),), 6.0)))
    for s_, m_ in ((sp, mp), (sb, mb)):
        np.testing.assert_array_equal(
            tisect.occluded(s_, m_, to, td, tm6, device="cpu").numpy(), oj)
    it = tisect.make_interaction(sp, mp, to, td, hp)
    ij = jisect.make_interaction(js, jm, jnp.asarray(o), jnp.asarray(d), hj)
    for k in ("p", "n", "ns", "uv"):
        np.testing.assert_allclose(it[k].numpy()[m], np.asarray(ij[k])[m],
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    for k in ("mat_id", "light_id", "kind"):
        np.testing.assert_array_equal(it[k].numpy()[m], np.asarray(ij[k])[m])


def test_torch_instanced_scene_two_level_tables(monkeypatch):
    """The same scene on the two-level instanced tables (forced by a
    split-free stand-in: a velocity of zero keeps it static, so the tables
    are built directly) returns the same hits as the single-level ones."""
    sp, _, mp = _pyramids(tbuilder.SceneBuilder, accel="pallas", device="cpu")
    inst = dict(otri_v=sp["otri_v"].numpy(), otri_uv=sp["otri_uv"].numpy(),
                otri_mat=sp["otri_prop"].numpy()[:, 0],
                fwd=sp["inst_fwd"].numpy(), inv=sp["inst_inv"].numpy(),
                base=sp["inst_base"].numpy(), count=sp["inst_count"].numpy(),
                vel=sp["inst_vel"].numpy())
    arrays, k2 = trace2.build_tri_blocks2_inst(
        sp["tri_v"].numpy()[:mp.n_tri], inst["otri_v"], list(inst["fwd"]),
        list(inst["inv"]), list(inst["base"]), list(inst["count"]), g=4)
    s2 = {k: v for k, v in sp.items() if not k.startswith("pk_")}
    s2.update(_T(arrays))
    m2 = dataclasses.replace(mp, block_k=k2, block_g=4)
    o, d = _scene_rays(1)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h1 = tisect.intersect(sp, mp, to, td, 1e30, device="cpu")
    h2 = tisect.intersect(s2, m2, to, td, 1e30, device="cpu")
    for k in ("valid", "kind", "idx", "t"):
        assert torch.equal(h1[k], h2[k]), k


def _lamps(B, runtime, **build_kw):
    v = np.asarray([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5],
                    [-0.5, 0, 0.5]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    b = B()
    mid = b.add_model(v, f, emission=(8.0, 6.0, 4.0))
    for t in ((-1.5, 2.0, 0), (1.5, 2.5, 0)):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        b.add_model_instance(mid, m, runtime=runtime)
    b.add_quad([-4, 0, -4], [8, 0, 0], [0, 0, 8],
               material=b.add_diffuse((0.6, 0.6, 0.6)))
    b.set_camera([0, 3, -6], [0, 1, 0], math.radians(45), (24, 24))
    return b.build(**build_kw)


def test_torch_instanced_emissive_lights_match_jax():
    """Instances of an emissive model get per-instance per-triangle area
    lights: the light tables, the hit-side light ids and the render equal
    the JAX package's (> 99% of values within rtol=1e-4, atol=1e-5)."""
    js, jc, jm = _lamps(JBuilder, True)
    ts, tc, tm = _lamps(tbuilder.SceneBuilder, True, device="cpu")
    assert tm.n_lights == jm.n_lights == 4 and tm.n_inst == 2
    for k in ("light_power", "light_area", "light_cdf", "light_shape",
              "ilight_map", "inst_slot_base"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, err_msg=k)
    kw = dict(spp=4, max_depth=3)
    want = np.asarray(j_render(js, jc, jm, JConfig(
        sampler=JSampler(x_samples=2, y_samples=2, seed=5), **kw)))
    got = t_render(ts, tc, tm, TConfig(
        sampler=TSampler(x_samples=2, y_samples=2, seed=5), **kw),
        device="cpu").numpy()
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).mean() > 0.99
    assert got.max() > 1.0          # the lights actually illuminate
    # duplicated world geometry renders alike (the JAX package's rule)
    dup = t_render(*_lamps(tbuilder.SceneBuilder, False, device="cpu"),
                   TConfig(sampler=TSampler(x_samples=2, y_samples=2, seed=5),
                           **kw), device="cpu").numpy()
    assert np.isclose(got, dup, rtol=1e-3, atol=1e-3).mean() > 0.99


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_runtime_instances_render_matches_jax(regenerate):
    """Run-time instances render like the JAX package's (> 99% of values
    within rtol=1e-4, atol=1e-5, depth 3) and like duplicated geometry."""
    js, jc, jm = _pyramids(JBuilder, world_mesh=False, floor=True)
    ts, tc, tm = _pyramids(tbuilder.SceneBuilder, world_mesh=False,
                           floor=True, device="cpu")
    kw = dict(spp=4, max_depth=3, regenerate=regenerate)
    want = np.asarray(j_render(js, jc, jm, JConfig(
        sampler=JSampler(x_samples=2, y_samples=2), **kw)))
    tcfg = TConfig(sampler=TSampler(x_samples=2, y_samples=2), **kw)
    got = t_render(ts, tc, tm, tcfg, device="cpu").numpy()
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5).mean() > 0.99
    dup = t_render(*_pyramids(tbuilder.SceneBuilder, runtime=False,
                              world_mesh=False, floor=True, device="cpu"),
                   tcfg, device="cpu").numpy()
    assert np.isclose(got, dup, rtol=1e-3, atol=1e-4).mean() > 0.98


@pytest.fixture(scope="module")
def tlas_miniature():
    """The San-Miguel analog with its 8 shrubs kept as run-time instances
    (PT_FLATTEN_MAX=0): the port's traversal build, its brute build, and
    the JAX package's traversal build."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PT_FLATTEN_MAX", "0")
    try:
        kw = dict(resolution=(32, 18), n_tris=20_000, foliage=8)
        own = tscenes.sanmiguel_analog(device="cpu", **kw)
        brute = tscenes.sanmiguel_analog(accel="brute", device="cpu", **kw)
        jax_ = jscenes.sanmiguel_analog(**kw)
    finally:
        mp.undo()
    return own, brute, jax_


def test_torch_tlas_foliage_tables(tlas_miniature):
    """What PT_FLATTEN_MAX=0 builds: plain two-level tables for the opaque
    set, instanced two-level tables with the shrub stored once for the
    alpha set, as the JAX builder does."""
    (ts, _, tm), _, (js, _, jm) = tlas_miniature
    assert tm.n_inst == jm.n_inst == 8 and tm.n_obj_tri == 96
    assert tm.alpha_cull_mask and jm.alpha_cull_mask
    assert "pk_l1_base" in ts and "pk_blk_src" not in ts
    assert "pka_blk_src" in ts and "pka_l1_base" in ts
    assert ts["pka_l1box"].shape[0] == 8 and ts["pka_l1_base"].shape[0] == 1
    assert ts["pka_tri"].shape[0] == tm.block_g * tm.alpha_block_k
    for k in ("pk_slot2tri", "pka_slot2tri", "pka_blk_src", "pka_blk_inst",
              "pka_l1_base"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
    np.testing.assert_allclose(ts["pka_inst_inv"].numpy(),
                               np.asarray(js["pka_inst_inv"]), rtol=1e-6)


def test_torch_tlas_foliage_matches_brute_and_jax(tlas_miniature):
    """The instanced-foliage miniature: closest hits of the traversal path
    equal the brute scan's except where the masked closest pass skips a
    transparent hit, the shadow predicate equals the brute one's lane for
    lane (MASK mode is deterministic) and the JAX package's, and the
    depth-2 render agrees with the brute build's on > 99% of values
    (rtol=1e-4, atol=1e-5; deeper, this scene's normal map decorrelates
    paths, so depth 2 is the rule here as for the flattened scene)."""
    (ts, tc, tm), (bs, _, bm), (js, _, jm) = tlas_miniature
    rng = np.random.default_rng(23)
    n = 1024
    x = rng.uniform(3.0, 97.0, n).astype(np.float32)
    z = rng.uniform(3.0, 97.0, n).astype(np.float32)
    px = np.asarray([ts["inst_fwd"][i % 8, 0, 3] for i in range(n)])
    pz = np.asarray([ts["inst_fwd"][i % 8, 2, 3] for i in range(n)])
    x[: n // 2] = px[: n // 2] + rng.normal(0, 1.0, n // 2)
    z[: n // 2] = pz[: n // 2] + rng.normal(0, 1.0, n // 2)
    y = tscenes._sm_height(x, z) + rng.uniform(0.05, 2.5, n).astype(np.float32)
    o = np.stack([x, y, z], -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hp = tisect.intersect(ts, tm, to, td, 1e30, device="cpu")
    hb = tisect.intersect(bs, bm, to, td, 1e30, device="cpu")
    miss = ~hp["valid"] & ~hb["valid"]
    same = hp["valid"] & hb["valid"] & (hp["idx"] == hb["idx"]) \
        & (hp["kind"] == hb["kind"])
    foliage_b = (hb["kind"] == SHAPE_ITRI) & hb["valid"]
    assert int(foliage_b.sum()) > 30 and int((same & foliage_b).sum()) > 10
    # every difference is a foliage hit the masked pass skipped
    assert bool((same | miss | foliage_b).all())
    assert torch.allclose(hp["t"][same], hb["t"][same], rtol=1e-5)
    tmx = torch.full((n,), 1e30)
    op = tisect.occluded(ts, tm, to, td, tmx, device="cpu")
    ob = tisect.occluded(bs, bm, to, td, tmx, device="cpu")
    oj = np.asarray(jisect.occluded(js, jm, jnp.asarray(o), jnp.asarray(d),
                                    jnp.full((n,), 1e30)))
    assert torch.equal(op, ob)
    np.testing.assert_array_equal(op.numpy(), oj)
    cfg = TConfig(spp=2, max_depth=2, regenerate=True,
                  sampler=TSampler(x_samples=2, y_samples=1, seed=3))
    got = t_render(ts, tc, tm, cfg, device="cpu")
    want = t_render(bs, tc, bm, cfg, device="cpu")
    # the masked path skips transparent hits where the unmasked brute path
    # spends a bounce on them: statistically equal, not sample for sample
    assert abs(float(got.mean()) - float(want.mean())) \
        < 0.05 * float(want.mean())
    unmasked = dataclasses.replace(tm, alpha_cull_mask=False)
    exact = t_render(ts, tc, unmasked, cfg, device="cpu")
    assert float(torch.isclose(exact, want, rtol=1e-4, atol=1e-5)
                 .float().mean()) > 0.99


def test_torch_from_numpy_scene_instanced():
    """A JAX scene with run-time instances carries across: the rebuilt
    single-level instanced tables have the reference's slot ids and both
    packages return the same intersect result."""
    js, jc, jm = _pyramids(JBuilder, accel="pallas")
    ts, tc, tm = _carry(js, jc, jm)
    assert tm.n_inst == 3 and tm.accel == "pallas"
    for k in ("pk_slot2tri", "pk_blk_src", "pk_blk_inst"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    o, d = _scene_rays(2)
    hj = jisect.intersect(js, jm, jnp.asarray(o), jnp.asarray(d), 1e30)
    ht = tisect.intersect(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                          1e30, device="cpu")
    m = np.asarray(hj["valid"])
    np.testing.assert_array_equal(ht["valid"].numpy(), m)
    for k in ("kind", "idx"):
        np.testing.assert_array_equal(ht[k].numpy()[m], np.asarray(hj[k])[m])
    np.testing.assert_allclose(ht["t"].numpy()[m], np.asarray(hj["t"])[m],
                               rtol=1e-4, atol=1e-5)
