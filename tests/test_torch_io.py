"""pathtracing_tpu_torch's io package against the JAX package's: Radiance
HDR files bit-equal both ways, OBJ (native parser and Python loop) and
glTF / .glb imports giving the same scene arrays, then the same image
(99% rule), and the port's scene cache (round trip bit-equal; a cache of
the JAX package or of an old version refused)."""
import base64
import json
import math
import struct

import numpy as np
import pytest
import torch

from pathtracing_tpu.core.rng import SamplerConfig as JSampler
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.integrators.render import render_image as j_render
from pathtracing_tpu.io import cache as jcache
from pathtracing_tpu.io import gltf as jgltf
from pathtracing_tpu.io import hdr as jhdr
from pathtracing_tpu.io import obj as jobj
from pathtracing_tpu.scene.builder import SceneBuilder as JBuilder
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.core.rng import SamplerConfig as TSampler
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render_image as t_render
from pathtracing_tpu_torch.io import cache as tcache
from pathtracing_tpu_torch.io import gltf as tgltf
from pathtracing_tpu_torch.io import hdr as thdr
from pathtracing_tpu_torch.io import obj as tobj
from pathtracing_tpu_torch.native import loader as tloader
from pathtracing_tpu_torch.scene.builder import SceneBuilder as TBuilder
from test_torch_native import jax_native_builder

torch.set_num_threads(2)

_SCENE_KEYS = ("tri_v", "tri_n", "tri_uv", "tri_tan", "tri_prop", "mat_type",
               "mat_base", "mat_rough", "mat_metal", "mat_ior", "mat_tex",
               "mat_alpha_mode", "mat_alpha_cutoff", "tex_texels",
               "tex_info_i", "tex_info_f", "light_type", "light_color",
               "light_shape", "light_power", "light_cdf", "light_emtex",
               "med_sigma_a", "med_sigma_s")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_builder():
    jax_native_builder()


def _both(make, res=(16, 16)):
    """make(builder module's SceneBuilder) -> builder, for both packages;
    returns the JAX and the port (scene, cam, meta)."""
    jb, tb = make(JBuilder), make(TBuilder)
    for b in (jb, tb):
        b.add_uniform_inf_light((0.6, 0.7, 0.9))
        b.add_distant_light((-0.3, -1.0, -0.2), (2.0, 2.0, 2.0))
        b.set_camera([2.5, 3.0, -2.0], [2.5, 0.0, 2.5], math.radians(50), res)
    return jb.build(), tb.build(device="cpu")


def _same_scene(j, t, keys=_SCENE_KEYS):
    (js, _, jm), (ts, _, tm) = j, t
    assert (tm.n_tri, tm.n_mat, tm.n_lights, tm.accel) == \
        (jm.n_tri, jm.n_mat, jm.n_lights, jm.accel)
    for k in keys:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)


def _same_image(j, t, spp=2, depth=3):
    (js, jc, jm), (ts, tc, tm) = j, t
    kw = dict(spp=spp, max_depth=depth, integrator="path")
    want = np.asarray(j_render(js, jc, jm, JConfig(
        sampler=JSampler(x_samples=spp, y_samples=1, seed=7), **kw)))
    got = t_render(ts, tc, tm, TConfig(
        sampler=TSampler(x_samples=spp, y_samples=1, seed=7), **kw),
        device="cpu").numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, close.mean()


# ---- Radiance HDR

def _sky(h, w, seed=0):
    img = (np.random.default_rng(seed).uniform(0, 6, (h, w, 3)) ** 2
           ).astype(np.float32)
    img[0, :3] = 0.0                 # black pixels take exponent 0
    return img


@pytest.mark.parametrize("w", [5, 40, 300])
def test_torch_hdr_write_read_bit_equal(tmp_path, w):
    """Widths below 8 are written flat, others as literal RLE scanlines
    (300: more than two 128-byte literal chunks per channel)."""
    img = _sky(7, w)
    pj, pt = tmp_path / "j.hdr", tmp_path / "t.hdr"
    jhdr.write_hdr(pj, img)
    thdr.write_hdr(pt, img)
    assert pt.read_bytes() == pj.read_bytes()
    for p in (pj, pt):
        np.testing.assert_array_equal(thdr.read_hdr(p), jhdr.read_hdr(p))


def test_torch_hdr_reads_runs_and_flipped_files(tmp_path):
    """A file with run-length runs (count > 128) in its scanlines and a
    +Y (bottom-up) file decode as the JAX reader decodes them."""
    w, h = 16, 3
    rows = []
    for y in range(h):
        row = bytes([2, 2, 0, w])
        for c in range(4):
            # a run of 10 equal bytes, then 6 literals
            val = 120 + 10 * c + y if c < 3 else 129
            row += bytes([128 + 10, val]) + bytes([6]) + bytes(
                range(60 + c, 66 + c))
        rows.append(row)
    rle = tmp_path / "rle.hdr"
    rle.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 3 +X 16\n"
                    + b"".join(rows))
    flat = tmp_path / "flip.hdr"
    rgbe = np.random.default_rng(3).integers(1, 255, (4, 6, 4), np.uint8)
    flat.write_bytes(b"#?RGBE\n\n+Y 4 +X 6\n" + rgbe.tobytes())
    for p in (rle, flat):
        got, want = thdr.read_hdr(p), jhdr.read_hdr(p)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_torch_env_light_from_hdr_file(tmp_path):
    """add_env_light_from_file on a .hdr: the same texels and importance
    tables as the JAX builder's."""
    p = tmp_path / "sky.hdr"
    thdr.write_hdr(p, _sky(32, 64, seed=1))

    def make(B):
        b = B()
        b.add_env_light_from_file(p, scale=0.7)
        b.add_sphere([2.5, 0.5, 2.5], 0.5, material=b.add_diffuse())
        return b

    j, t = _both(make, (8, 8))
    _same_scene(j, t, ("tex_texels", "tex_info_i", "env_weights", "env_cdf",
                       "env_total", "light_power", "light_env_slot"))


# ---- OBJ

_MTL = ("newmtl red\nKd 0.8 0.1 0.1\nNs 50\n"
        "newmtl glow\nKd 0.1 0.1 0.1\nKe 3.0 2.0 1.0\n"
        "newmtl glass\nKd 1 1 1\nNi 1.5\nd 0.2\n"
        "newmtl mirror\nKd 0.05 0.05 0.05\nKs 0.9 0.9 0.9\n")


def _grid_obj(path, side, y=0.0, mat_rows=True):
    """A side x side vertex grid, two triangles per cell, with normals and
    uvs; rows of cells alternate between the MTL's materials, and every
    tenth cell is a quad (fan-triangulated) with negative indices."""
    lines = ["mtllib m.mtl"]
    for i in range(side):
        for j in range(side):
            lines.append(f"v {i * 0.1:.4f} {y + 0.05 * math.sin(i * j):.5f} "
                         f"{j * 0.1:.4f}")
            lines.append(f"vt {i / side:.4f} {j / side:.4f}")
    lines.append("vn 0 1 0")
    mats = ("red", "mirror", "glass", "red", "glow")
    for i in range(side - 1):
        if mat_rows:
            lines.append(f"usemtl {mats[i % len(mats)]}")
        for j in range(side - 1):
            a = i * side + j + 1
            b, c = a + 1, a + side
            d = c + 1
            if (i * side + j) % 10 == 0:
                n = side * side
                lines.append(f"f {a - n - 1}/{a - n - 1}/1 {c - n - 1}/"
                             f"{c - n - 1}/1 {d - n - 1}/{d - n - 1}/1 "
                             f"{b - n - 1}/{b - n - 1}/1")
            else:
                lines.append(f"f {a}/{a}/1 {c}/{c}/1 {b}/{b}/1")
                lines.append(f"f {b}//1 {c}//1 {d}//1")
    path.write_text("\n".join(lines) + "\n")
    (path.parent / "m.mtl").write_text(_MTL)


def test_torch_obj_native_and_python_match_jax(tmp_path, monkeypatch):
    """The native parser and the Python loop give the same add_mesh
    sequence (arrays, materials, lights), which equals the JAX loader's."""
    obj = tmp_path / "g.obj"
    _grid_obj(obj, 12)
    parsed = tloader.native_parse_obj(obj)
    assert parsed is not None and parsed["usemtl"][:2] == ["red", "mirror"]

    def load(B, mod, python):
        b = B()
        if python:
            monkeypatch.setattr(mod.__name__.replace(".io.obj",
                                                     ".native.loader")
                                + ".native_parse_obj", lambda p: None)
        stats = mod.load_obj(obj, b, scale=2.0)
        monkeypatch.undo()
        return b, stats

    jb, js = load(JBuilder, jobj, False)
    for python in (False, True):
        tb, ts = load(TBuilder, tobj, python)
        assert ts == js and ts["n_materials"] == 4
        for k in ("v", "n", "uv", "tan", "prop"):
            np.testing.assert_array_equal(np.asarray(tb._tri[k]),
                                          np.asarray(jb._tri[k]), err_msg=k)
        assert tb._mat["type"] == jb._mat["type"]
        assert len(tb._lights) == len(jb._lights) > 0


def test_torch_obj_render_matches_jax(tmp_path):
    """An OBJ of 4,802 triangles (above the 4,096-prim cut: the traversal
    tables) with the MTL's four materials and emissive cells, imported by
    both packages: same scene arrays, same image."""
    obj = tmp_path / "g.obj"
    _grid_obj(obj, 50)

    def make(B):
        b = B()
        (jobj if B is JBuilder else tobj).load_obj(obj, b)
        return b

    j, t = _both(make)
    assert t[2].accel == "pallas" and t[2].n_tri == 2 * 49 * 49
    _same_scene(j, t)
    _same_image(j, t)


# ---- glTF

def _gltf(path, glb=False, interleaved=False, side=8):
    """A side x side grid (indexed uint32, with normals and uvs; optionally
    the position / normal / uv attributes interleaved in one strided
    buffer view) under a rotated, scaled, translated parent node, and a
    second mesh node reusing it; materials: PBR factors with alpha MASK,
    transmission + KHR_materials_volume (a medium), and an emissive one
    with KHR_materials_emissive_strength."""
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pos = np.stack([i * 0.2, np.sin(i * j) * 0.05, j * 0.2], -1).reshape(
        -1, 3).astype(np.float32)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (len(pos), 1))
    uv = np.stack([i / side, j / side], -1).reshape(-1, 2).astype(np.float32)
    a = (i[:-1, :-1] * side + j[:-1, :-1]).ravel()
    idx = np.concatenate([np.stack([a, a + side, a + 1], -1),
                          np.stack([a + 1, a + side, a + side + 1], -1)]
                         ).astype(np.uint32)
    n = len(pos)
    if interleaved:
        inter = np.concatenate([pos, nrm, uv], 1).astype(np.float32)
        buf = inter.tobytes() + idx.tobytes()
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": n * 32,
                  "byteStride": 32},
                 {"buffer": 0, "byteOffset": n * 32,
                  "byteLength": idx.nbytes}]
        acc = [{"bufferView": 0, "byteOffset": 0, "componentType": 5126,
                "count": n, "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
                "count": n, "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 24, "componentType": 5126,
                "count": n, "type": "VEC2"}]
        iview = 1
    else:
        buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
        off = np.cumsum([0, pos.nbytes, nrm.nbytes, uv.nbytes])
        views = [{"buffer": 0, "byteOffset": int(o), "byteLength": int(s)}
                 for o, s in zip(off, (pos.nbytes, nrm.nbytes, uv.nbytes,
                                       idx.nbytes))]
        acc = [{"bufferView": k, "componentType": 5126, "count": n,
                "type": t} for k, t in enumerate(("VEC3", "VEC3", "VEC2"))]
        iview = 3
    acc.append({"bufferView": iview, "componentType": 5125,
                "count": idx.size, "type": "SCALAR"})
    g = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"children": [1, 2], "translation": [1.0, 0.0, 0.5],
                   "rotation": [0.0, 0.0998, 0.0, 0.995],
                   "scale": [1.5, 1.0, 1.5]},
                  {"mesh": 0},
                  {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0,
                                         0.3, 0.6, 0.2, 1]}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3,
            "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 0}, "indices": 3,
                             "material": 2},
                            {"attributes": {"POSITION": 0, "NORMAL": 1},
                             "indices": 3, "material": 1}]}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.6, 0.3, 1],
                                      "roughnessFactor": 0.4,
                                      "metallicFactor": 0.2},
             "alphaMode": "MASK", "alphaCutoff": 0.3},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.9, 1, 1]},
             "extensions": {
                 "KHR_materials_transmission": {"transmissionFactor": 1.0},
                 "KHR_materials_ior": {"ior": 1.4},
                 "KHR_materials_volume": {"thicknessFactor": 0.5,
                                          "attenuationDistance": 2.0,
                                          "attenuationColor": [0.5, 0.8, 1]}}},
            {"emissiveFactor": [1.0, 0.8, 0.5],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 4.0}}}],
        "buffers": [{"byteLength": len(buf)}],
        "bufferViews": views, "accessors": acc,
    }
    if glb:
        js = json.dumps(g).encode()
        js += b" " * (-len(js) % 4)
        binp = buf + b"\x00" * (-len(buf) % 4)
        body = (struct.pack("<III", 0x46546C67, 2, 0)
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(binp), 0x004E4942) + binp)
        path.write_bytes(body[:8] + struct.pack("<I", len(body)) + body[12:])
    else:
        g["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                  + base64.b64encode(buf).decode())
        path.write_text(json.dumps(g))
    return path


@pytest.mark.parametrize("kind", ["gltf", "glb", "interleaved"])
def test_torch_gltf_loads_like_jax(tmp_path, kind):
    """.gltf (data URI), .glb and interleaved (strided) accessors: the
    same stats and scene arrays (node matrices, materials, the volume's
    medium, emissive strength lights) as the JAX loader."""
    p = _gltf(tmp_path / f"m.{'glb' if kind == 'glb' else 'gltf'}",
              glb=kind == "glb", interleaved=kind == "interleaved")
    stats = {}

    def make(B):
        b = B()
        mod = jgltf if B is JBuilder else tgltf
        stats[B] = mod.load_gltf(p, b, scale=1.5)
        return b

    j, t = _both(make, (8, 8))
    assert stats[JBuilder] == stats[TBuilder]
    assert stats[TBuilder]["n_meshes"] == 3 and t[2].n_media == 1
    _same_scene(j, t)


def test_torch_gltf_render_matches_jax(tmp_path):
    """A .glb of 5,000 triangles (the traversal tables) with the three
    materials: the same image as the JAX package's import."""
    p = _gltf(tmp_path / "m.glb", glb=True, side=30)

    def make(B):
        b = B()
        (jgltf if B is JBuilder else tgltf).load_gltf(p, b, scale=2.0)
        return b

    j, t = _both(make)
    assert t[2].accel == "pallas" and t[2].n_tri == 3 * 2 * 29 * 29
    _same_image(j, t)


# ---- the scene cache

@pytest.mark.parametrize("name", ["cornell", "obj"])
def test_torch_scene_cache_roundtrip(tmp_path, name):
    """save_scene / load_scene: every array, the camera and the meta come
    back equal (the meta hashable), and the render is bit-equal; the OBJ
    scene carries the traversal tables."""
    if name == "cornell":
        scene, cam, meta = tscenes.cornell_box(resolution=(12, 12),
                                               device="cpu")
    else:
        obj = tmp_path / "g.obj"
        _grid_obj(obj, 50)
        b = TBuilder()
        tobj.load_obj(obj, b)
        b.add_uniform_inf_light((1, 1, 1))
        b.set_camera([2.5, 3, -2], [2.5, 0, 2.5], 0.8, (12, 12))
        scene, cam, meta = b.build(device="cpu")
        assert meta.accel == "pallas"
    p = tmp_path / "c.npz"
    tcache.save_scene(p, scene, cam, meta)
    scene2, cam2, meta2 = tcache.load_scene(p, device="cpu")
    assert meta2 == meta and hash(meta2) == hash(meta)
    assert sorted(scene2) == sorted(scene) and sorted(cam2) == sorted(cam)
    for k in scene:
        assert scene2[k].dtype == scene[k].dtype and torch.equal(
            scene2[k], scene[k]), k
    cfg = TConfig(spp=2, max_depth=3, sampler=TSampler(x_samples=2,
                                                       y_samples=1))
    assert torch.equal(t_render(scene2, cam2, meta2, cfg, device="cpu"),
                       t_render(scene, cam, meta, cfg, device="cpu"))


def test_torch_cache_refuses_jax_and_stale_caches(tmp_path):
    """A cache the JAX package wrote, and one of another version of this
    package's format, raise StaleCacheError."""
    from pathtracing_tpu import scenes as jscenes
    jp = tmp_path / "jax.npz"
    jcache.save_scene(jp, *jscenes.furnace(resolution=(4, 4)))
    with pytest.raises(tcache.StaleCacheError):
        tcache.load_scene(jp, device="cpu")
    tp = tmp_path / "old.npz"
    tcache.save_scene(tp, *tscenes.furnace(resolution=(4, 4), device="cpu"))
    z = dict(np.load(tp, allow_pickle=False))
    hdr = json.loads(bytes(z["header"]).decode())
    hdr["version"] -= 1
    z["header"] = np.frombuffer(json.dumps(hdr).encode(), np.uint8)
    np.savez(tp, **z)
    with pytest.raises(tcache.StaleCacheError):
        tcache.load_scene(tp, device="cpu")
