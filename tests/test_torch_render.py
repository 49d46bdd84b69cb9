"""End-to-end parity of pathtracing_tpu_torch's renders with the JAX
package: the San-Miguel-analog slices, untextured and faithful (carried
across with convert.from_numpy_scene, and built by the port's own builder
on its two-level traversal path: these small scenes are forced onto it
with TWOLEVEL_MIN = 0, the single-level path has its own tests in
test_torch_trace1.py), the committed goldens, and the import guard."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.accel import trace2
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.scene import builder as tbuilder
from test_torch_native import jax_native_builder


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    """Compare only with JAX builds made by its native SAH builder
    (test_torch_native.py)."""
    jax_native_builder()


torch.set_num_threads(2)


def _own_two_level(**kw):
    """The port's own build of sanmiguel_analog forced onto the two-level
    tables (sets of 65,536 triangles or fewer go to the single-level
    kernel by default)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    try:
        own = tscenes.sanmiguel_analog(accel="pallas", device="cpu", **kw)
    finally:
        mp.undo()
    assert "pk_l1_base" in own[0]
    assert "pka_tri" not in own[0] or "pka_l1_base" in own[0]
    return own

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _carry(scene, cam, meta):
    return convert.from_numpy_scene(
        {k: np.asarray(v) for k, v in scene.items()},
        {k: (np.asarray(v) if k != "resolution" else v)
         for k, v in cam.items()},
        {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)},
        device="cpu")


def _cfgs(regenerate):
    kw = dict(spp=2, max_depth=4, integrator="path", regenerate=regenerate)
    return (JConfig(sampler=JSampler(x_samples=2, y_samples=1, seed=3), **kw),
            TConfig(sampler=TSampler(x_samples=2, y_samples=1, seed=3), **kw))


@pytest.fixture(scope="module")
def slice_scenes():
    jscene = jscenes.sanmiguel_analog(resolution=(32, 32), n_tris=8_000,
                                      faithful=False, accel="brute")
    own = _own_two_level(resolution=(32, 32), n_tris=8_000, faithful=False)
    return jscene, _carry(*jscene), own


@pytest.fixture(scope="module")
def faithful_scenes():
    """The faithful miniature three ways: the JAX package's brute build,
    that build carried across with its table split rebuilt, and the
    port's own build on the two-level tables."""
    kw = dict(resolution=(32, 32), n_tris=2_000, foliage=8)
    jscene = jscenes.sanmiguel_analog(accel="brute", **kw)
    carried = _carry(*jscene)
    # the carried scene runs the masked split-table path too
    jpallas = dataclasses.replace(jscene[2], accel="pallas")
    mp = pytest.MonkeyPatch()
    mp.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    try:
        # no pk_* tables in the brute JAX scene: the rebuilt tables take
        # the builder's rule, here forced to two-level like `own`
        carried_split = convert.from_numpy_scene(
            {k: np.asarray(v) for k, v in jscene[0].items()},
            {k: (np.asarray(v) if k != "resolution" else v)
             for k, v in jscene[1].items()},
            {f.name: getattr(jpallas, f.name)
             for f in dataclasses.fields(jpallas)}, device="cpu")
    finally:
        mp.undo()
    own = _own_two_level(**kw)
    return jscene, carried, carried_split, own


def test_torch_faithful_scene_arrays_match_jax(faithful_scenes):
    (js, _, jm), carried, carried_split, own = faithful_scenes
    scene, _, meta = own
    assert meta.accel == "pallas" and carried[2].accel == "brute"
    for sc, m in (own[::2], carried_split[::2]):
        assert m.has_alpha and m.alpha_cull_mask and m.alpha_block_k > 0
        assert "pka_tri" in sc and "pka_mask" in sc
        assert m.has_normal_maps and not m.analytic_alpha
    assert not carried[2].alpha_cull_mask and "pka_tri" not in carried[0]
    assert meta.n_tri == jm.n_tri and meta.n_lights == jm.n_lights
    assert meta.mat_tex_present == jm.mat_tex_present
    assert meta.mats_present == jm.mats_present
    shared = [k for k in scene if k.startswith(("tri_", "mat_", "tex_",
                                                "light_", "sph_", "quad_"))]
    assert {"tri_tan", "mat_tex", "mat_alpha_mode", "tex_texels"} <= \
        set(shared)
    for k in shared + ["inf_idx", "scene_lo", "scene_hi"]:
        np.testing.assert_array_equal(scene[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(carried[0][k].numpy(),
                                      np.asarray(js[k]), err_msg=k)
    # the carried scene's rebuilt tables are the port's own
    for k in ("pk_slot2tri", "pka_slot2tri", "pka_mask", "pka_tri"):
        assert torch.equal(carried_split[0][k], scene[k]), k


def _faithful_cfgs(max_depth, regenerate):
    kw = dict(spp=4, max_depth=max_depth, integrator="path",
              regenerate=regenerate)
    return (JConfig(sampler=JSampler(x_samples=2, y_samples=2, seed=3), **kw),
            TConfig(sampler=TSampler(x_samples=2, y_samples=2, seed=3), **kw))


@pytest.mark.parametrize("regenerate", [True, False])
def test_torch_faithful_slice_render_matches_jax(faithful_scenes, regenerate):
    """Textures, normal map, alpha foliage, glass, metal and lamp meshes,
    sample for sample against the JAX package: > 99% of values within
    rtol=1e-4, atol=1e-5 at max_depth=2 (two surface hits with their
    texture fetches, normal mapping, alpha tests and shadow chains).

    Sample-exact parity is held on the unmasked paths only, as in the JAX
    package's own faithful-scene test: the brute scan, and the split
    tables with the micro-masks left unused.  The masked closest pass
    skips definitely-transparent foliage hits in the traversal, where the
    unmasked path spends a bounce (and that bounce's random numbers) to
    pass through them, so its see-through paths differ sample by sample;
    test_torch_faithful_slice_render_at_depth_5 holds it statistically.

    Why depth 2: the terrain's 512-texel normal map is sampled at uv up
    to 8 and turns the normal by ~0.5 rad per texel, so a one-ulp
    difference in a hit position (the two packages' compiled code rounds
    a few sums differently) moves the shading normal by ~1e-4 and the
    path has decorrelated two bounces later.  Measured on this scene,
    brute against brute: 99.0% of values agree at depth 2, 95% at depth
    3, 85% at depth 5."""
    (js, jc, jm), carried, carried_split, own = faithful_scenes
    jcfg, tcfg = _faithful_cfgs(2, regenerate)
    want = np.asarray(j_render(js, jc, jm, jcfg))
    assert np.isfinite(want).all() and want.mean() > 0.01
    unmasked = dataclasses.replace(own[2], alpha_cull_mask=False)
    for scene, cam, meta in (carried, (own[0], own[1], unmasked)):
        got = t_render(scene, cam, meta, tcfg, device="cpu").numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, (meta.accel, close.mean())


def test_torch_faithful_slice_render_at_depth_5(faithful_scenes):
    """The slice's configuration at miniature size (spp=4, max_depth=5,
    regenerate): the masked split-table build (the port's own and the
    carried one, which must be the same image) and the brute build
    against the JAX package's image.  Paths decorrelate after a few
    bounces (see test_torch_faithful_slice_render_matches_jax), so this
    holds the estimator, not the samples: means within 1% (measured
    0.1%) and > 90% of values within rtol=5e-2, atol=1e-3 (measured
    97.8% masked, 98.9% brute)."""
    (js, jc, jm), carried, carried_split, own = faithful_scenes
    jcfg, tcfg = _faithful_cfgs(5, True)
    want = np.asarray(j_render(js, jc, jm, jcfg))
    images = [t_render(scene, cam, meta, tcfg, device="cpu").numpy()
              for scene, cam, meta in (carried, carried_split, own)]
    np.testing.assert_array_equal(images[1], images[2])
    for got in images[:2]:
        assert np.isfinite(got).all()
        assert abs(got.mean() - want.mean()) < 0.01 * want.mean()
        close = np.isclose(got, want, rtol=5e-2, atol=1e-3)
        assert close.mean() > 0.90, close.mean()


@pytest.mark.parametrize("regenerate", [True, False])
def test_torch_slice_render_matches_jax(slice_scenes, regenerate):
    (js, jc, jm), carried, own = slice_scenes
    assert carried[2].accel == "brute" and own[2].accel == "pallas"
    jcfg, tcfg = _cfgs(regenerate)
    want = np.asarray(j_render(js, jc, jm, jcfg))
    assert np.isfinite(want).all() and want.mean() > 0.01
    trace2.tri_intersect2.launches = 0
    for scene, cam, meta in (carried, own):
        got = t_render(scene, cam, meta, tcfg, device="cpu").numpy()
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, (meta.accel, close.mean())
    # the CPU path never launches the kernel (it takes the plain version)
    assert trace2.tri_intersect2.launches == 0


@pytest.mark.parametrize("two_level", [False, True])
def test_torch_carried_pallas_scene_rebuilds_tables(two_level, monkeypatch):
    """A JAX scene on its Pallas path carries across with the port's own
    tables of the same level (same SAH order => same slot ids): 12,000
    triangles go to the single-level tables by default, and to the
    two-level ones when both builders are told to (PT_TWOLEVEL_MIN there,
    TWOLEVEL_MIN here)."""
    if two_level:
        monkeypatch.setenv("PT_TWOLEVEL_MIN", "0")
        monkeypatch.setattr(tbuilder, "TWOLEVEL_MIN", 0)
    js, jc, jm = jscenes.sanmiguel_analog(resolution=(8, 8), n_tris=12_000,
                                          faithful=False)
    assert jm.accel == "pallas" and ("pk_l1_base" in js) == two_level
    scene, cam, meta = _carry(js, jc, jm)
    own = tscenes.sanmiguel_analog(resolution=(8, 8), n_tris=12_000,
                                   faithful=False, device="cpu")[0]
    assert meta.accel == "pallas"
    assert ("pk_l1_base" in scene) == two_level == ("pk_l1_base" in own)
    keys = ("pk_slot2tri", "pk_blk_lo", "pk_tri") + (
        ("pk_l1_base",) if two_level else ("pk_blkbox",))
    for k in keys:
        assert torch.equal(scene[k], own[k]), k


# name: (scene, config, sampler grid)
_GOLDENS = {
    "textured": (lambda m: m.textured_quad(resolution=(24, 24)),
                 dict(spp=4, max_depth=3, integrator="path"), (2, 2)),
    "cornell": (lambda m: m.cornell_box(resolution=(32, 32)),
                dict(spp=8, max_depth=4, integrator="path"), (4, 2)),
    "furnace": (lambda m: m.furnace(resolution=(16, 16)),
                dict(spp=8, max_depth=3, integrator="simple"), (4, 2)),
    "mat_test": (lambda m: m.mat_test(resolution=(36, 22), rows=4, cols=6),
                 dict(spp=4, max_depth=3, integrator="path"), (2, 2)),
}


@pytest.mark.parametrize("name", sorted(_GOLDENS))
def test_torch_goldens(name):
    """The port reproduces the JAX package's committed golden images
    (rtol=2e-4, atol=2e-5).  The goldens come from jitted XLA CPU code,
    which fuses some multiply-adds; the port rounds the ill-conditioned
    ones (hit points, sphere and quad tests, squared norms) alike."""
    build, kw, (xs, ys) = _GOLDENS[name]

    class _M:                                  # build on the CPU
        def __getattr__(self, a):
            fn = getattr(tscenes, a)
            return lambda *args, **k: fn(*args, device="cpu", **k)

    scene, cam, meta = build(_M())
    cfg = TConfig(sampler=TSampler(x_samples=xs, y_samples=ys, seed=11), **kw)
    got = t_render(scene, cam, meta, cfg, device="cpu").numpy()
    want = np.load(GOLDEN_DIR / f"{name}.npy")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_torch_render_stats_count_the_drain_tail(monkeypatch):
    """render(stats=) with regenerate: "iterations" counts the drain's
    bounce iterations and, while spans record (utils/profile.py),
    "deep_bounces" the lane bounces at or past path._DEEP_BOUNCE and
    "deep_rehits" those whose closest hit lies nearer than path._REHIT_T;
    the image does not depend on them."""
    from pathtracing_tpu_torch.integrators import path as tpath
    from pathtracing_tpu_torch.integrators.render import render
    from pathtracing_tpu_torch.utils.profile import recording
    scene, cam, meta = tscenes.cornell_box(resolution=(12, 12), device="cpu")
    cfg = TConfig(spp=2, max_depth=6, integrator="path", regenerate=True,
                  sampler=TSampler(x_samples=2, y_samples=1, seed=5))
    st0 = {}
    film0 = render(scene, cam, meta, cfg, device="cpu", stats=st0)
    assert "deep_bounces" not in st0 and "deep_rehits" not in st0
    st = {}
    with recording():
        film = render(scene, cam, meta, cfg, device="cpu", stats=st)
    assert st["iterations"] == st0["iterations"] >= 6
    assert st["n_rays"] == st0["n_rays"] > 288
    assert st["deep_bounces"] == 0 and st["deep_rehits"] == 0   # depth 6 < 20
    monkeypatch.setattr(tpath, "_DEEP_BOUNCE", 1)
    st1 = {}
    with recording():
        film1 = render(scene, cam, meta, cfg, device="cpu", stats=st1)
    assert st1["iterations"] == st["iterations"]
    assert 0 < st1["deep_bounces"] < st["n_rays"]
    assert st1["deep_rehits"] == 0              # no hit nearer than 1e-4
    monkeypatch.setattr(tpath, "_REHIT_T", 1e30)    # every hit counts
    st2 = {}
    with recording():
        render(scene, cam, meta, cfg, device="cpu", stats=st2)
    assert 0 < st2["deep_rehits"] <= st2["deep_bounces"] == st1["deep_bounces"]
    assert torch.equal(film["rgb"], film1["rgb"])
    assert torch.equal(film["rgb"], film0["rgb"])


def test_torch_entry_points_need_a_device_choice():
    """Without a GPU, public entry points raise unless device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tscenes.furnace(resolution=(4, 4))
    scene, cam, meta = tscenes.furnace(resolution=(4, 4), device="cpu")
    with pytest.raises(RuntimeError):
        t_render(scene, cam, meta, TConfig(spp=1, max_depth=1))


def test_torch_faithful_scene_and_env_light():
    """The faithful scene builds (its foliage instances are re-emitted as
    world triangles by default), a model can be kept as a run-time
    instance, and an environment-map light builds with the JAX builder's
    light and importance tables, bit for bit."""
    scene, _, meta = tscenes.sanmiguel_analog(resolution=(8, 8), n_tris=100,
                                              foliage=2, device="cpu")
    assert meta.has_alpha and meta.n_inst == 0 and meta.n_tri > 100 + 2 * 96
    b = tscenes.SceneBuilder()
    mv, mf, _ = tscenes._sm_foliage_model(np.random.default_rng(3))
    shrub = b.add_model(mv, mf)
    b.add_model_instance(shrub, runtime=True)
    b.set_camera([0, 1, -5], [0, 1, 0], 0.8, (4, 4))
    _, _, meta = b.build(device="cpu")
    assert meta.n_inst == 1 and meta.n_obj_tri == 96 and meta.n_tri == 0
    from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
    sky = np.random.default_rng(5).uniform(0.1, 2.0, (4, 8, 3)).astype(
        np.float32)
    built = []
    for B, kw in ((JBuilder, {}), (tscenes.SceneBuilder, dict(device="cpu"))):
        b = B()
        b.add_model_instance(b.add_model(mv, mf), runtime=True)
        b.add_env_light(b.textures.add_image(sky), scale=1.5)
        b.set_camera([0, 1, -5], [0, 1, 0], 0.8, (4, 4))
        built.append(b.build(**kw))
    (js, _, jm), (ts, _, tm) = built
    assert tm.n_env == jm.n_env == 1 and tm.has_emissive_tex
    for k in ("env_weights", "env_cdf", "env_total", "light_env_slot",
              "light_emtex", "light_power", "light_color", "inf_idx"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)


def test_torch_package_imports_no_jax():
    """Every module of the port imports without jax / pathtracing_tpu."""
    code = r"""
import importlib, pkgutil, sys
import pathtracing_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m.startswith("jaxlib.") or m == "pathtracing_tpu"
       or m.startswith("pathtracing_tpu.")]
assert not bad, bad
assert "triton" not in sys.modules
print("ok", len([m for m in sys.modules if m.startswith("pathtracing")]))
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
