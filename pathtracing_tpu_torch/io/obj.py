"""Wavefront OBJ + MTL loader (counterpart of pathtracing_tpu/io/obj.py).

Geometry goes through the native C++ parser (native/obj_parser.cpp) when
a toolchain is present, else through the Python line loop below; both
give the same add_mesh sequence (one mesh per material name, in order of
first appearance).  MTL files always parse in Python, and materials are
inferred with the reference's OBJ heuristic:

  opacity < 1 and Ni > 1.01         -> dielectric
  high Ks with dark Kd              -> conductor
  otherwise                         -> diffuse (roughness from Ns)
  map_d / d < 1                     -> alpha mask / blend
  Ke                                -> per-triangle area lights
Images (map_Kd, map_d) load through Pillow, imported only when named.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..scene.types import ALPHA_OPAQUE, ALPHA_BLEND, ALPHA_MASK


def _parse_mtl(path: Path):
    mats = {}
    cur = None
    if not path.exists():
        return mats
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "newmtl":
            cur = dict(kd=(0.8, 0.8, 0.8), ks=(0.0, 0.0, 0.0),
                       ke=(0.0, 0.0, 0.0), ns=0.0, ni=1.0, d=1.0,
                       map_kd=None, map_d=None, map_bump=None)
            mats[parts[1]] = cur
        elif cur is None:
            continue
        elif key in ("Kd", "Ks", "Ke"):
            cur[key.lower()] = tuple(float(x) for x in parts[1:4])
        elif key in ("Ns", "Ni", "d"):
            cur[key.lower()] = float(parts[1])
        elif key == "Tr":
            cur["d"] = 1.0 - float(parts[1])
        elif key in ("map_Kd", "map_d", "map_bump", "bump"):
            cur["map_" + ("bump" if key in ("map_bump", "bump")
                          else key.split("_")[1].lower())] = parts[-1]
    return mats


def _load_texture(builder, base_dir: Path, name, cache, srgb):
    if not name:
        return -1
    key = (name, srgb)
    if key in cache:
        return cache[key]
    p = base_dir / name
    if not p.exists():
        cache[key] = -1
        return -1
    from PIL import Image
    arr = np.asarray(Image.open(p).convert("RGBA"), np.float32) / 255.0
    if srgb:
        rgb = arr[..., :3]
        arr[..., :3] = np.where(rgb <= 0.04045, rgb / 12.92,
                                ((rgb + 0.055) / 1.055) ** 2.4)
    cache[key] = builder.textures.add_image(arr[::-1])
    return cache[key]


def _make_material(builder, m, base_dir, cache):
    """The reference's OBJ heuristic (Model.cpp:239-278)."""
    kd = np.asarray(m["kd"], np.float32)
    ks = np.asarray(m["ks"], np.float32)
    base_tex = _load_texture(builder, base_dir, m["map_kd"], cache, True)
    alpha_tex = _load_texture(builder, base_dir, m["map_d"], cache, False)
    has_alpha = alpha_tex >= 0 or m["d"] < 1.0
    mode = ALPHA_MASK if alpha_tex >= 0 else (
        ALPHA_BLEND if m["d"] < 1.0 else ALPHA_OPAQUE)
    if m["d"] < 1.0 and m["ni"] > 1.01:
        return builder.add_dielectric(ior=m["ni"], roughness=0.0,
                                      base_color=tuple(kd) if kd.max() > 0
                                      else (1, 1, 1), base_tex=base_tex)
    if ks.max() > 0.5 and kd.max() < 0.2:
        return builder.add_conductor(tuple(np.maximum(ks, 0.04)))
    rough = float(np.clip(1.0 - np.sqrt(min(m["ns"], 1000.0) / 1000.0),
                          0.05, 1.0))
    if alpha_tex < 0 and base_tex >= 0 and mode != ALPHA_OPAQUE:
        alpha_tex = base_tex
    return builder.add_diffuse(tuple(kd), roughness=rough, metallic=0.0,
                               base_tex=base_tex, alpha_tex=alpha_tex,
                               alpha_mode=mode, alpha_cutoff=0.5)


def _load_obj_native(parsed, path: Path, builder, scale, transform):
    """Build the scene from the C++ parser's arrays (obj_parser.cpp).
    Produces the same add_mesh sequence (same group order, same
    normal/uv presence decisions) as the pure-Python path below."""
    base_dir = path.parent
    vs = parsed["v"] * np.float32(scale)
    vns, vts = parsed["vn"], parsed["vt"]
    mtl = {}
    for name in parsed["mtllib"]:
        mtl.update(_parse_mtl(base_dir / name))

    names = parsed["usemtl"]
    tri = parsed["tri"]           # [F,3,3] (vi,ti,ni), -1 = absent
    tmat = parsed["tri_mat"]      # [F] usemtl index, -1 = none
    gname = np.asarray([None] + names, object)[tmat + 1]

    # group by material NAME in first-appearance order (dict semantics of
    # the Python path)
    order, seen = [], set()
    for nm in gname:
        if nm not in seen:
            seen.add(nm)
            order.append(nm)

    cache = {}
    n_tris = 0
    for mat_name, in [(nm,) for nm in order]:
        mask = gname == mat_name
        tris = tri[mask]
        m = mtl.get(mat_name)
        mat_id = _make_material(builder, m, base_dir, cache) if m else -1
        emission = None
        if m and max(m["ke"]) > 0:
            emission = m["ke"]
        vi = np.clip(tris[..., 0], 0, max(len(vs) - 1, 0))
        pos = vs[vi].reshape(-1, 3)
        idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
        ni = tris[..., 2]
        has_n = len(vns) and (ni >= 0).all() and (ni < len(vns)).all() \
            and ni.max() > 0
        normals = vns[ni].reshape(-1, 3) if has_n else None
        ti = tris[..., 1]
        has_t = len(vts) and (ti >= 0).all() and (ti < len(vts)).all() \
            and ti.max() > 0
        uvs = vts[ti].reshape(-1, 2) if has_t else None
        builder.add_mesh(pos, idx, normals=normals, uvs=uvs,
                         material=mat_id, emission=emission,
                         transform=transform)
        n_tris += len(tris)
    return dict(n_tris=n_tris, n_materials=len(mtl))


def load_obj(path, builder, scale: float = 1.0, transform=None):
    """Load an OBJ file (with MTL) into `builder`.  Returns stats dict.

    Geometry parsing goes through the native C++ parser when the
    toolchain is available (native/obj_parser.cpp — the Python line loop
    below is minutes-slow at San-Miguel scale); materials/MTL always
    parse in Python."""
    path = Path(path)
    from ..native.loader import native_parse_obj
    parsed = native_parse_obj(path)
    if parsed is not None:
        return _load_obj_native(parsed, path, builder, scale, transform)
    base_dir = path.parent
    vs, vns, vts = [], [], []
    groups = {}       # material name -> list of (vi, ti, ni) triples
    cur_mat = None
    mtl = {}
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "v":
            vs.append([float(x) for x in parts[1:4]])
        elif key == "vn":
            vns.append([float(x) for x in parts[1:4]])
        elif key == "vt":
            vts.append([float(parts[1]), float(parts[2])
                        if len(parts) > 2 else 0.0])
        elif key == "mtllib":
            mtl.update(_parse_mtl(base_dir / " ".join(parts[1:])))
        elif key == "usemtl":
            cur_mat = parts[1] if len(parts) > 1 else None
        elif key == "f":
            corner = []
            for p in parts[1:]:
                comp = p.split("/")
                vi = int(comp[0])
                ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
                corner.append((vi, ti, ni))
            # triangle fan for polygons (Assimp triangulates the same way)
            g = groups.setdefault(cur_mat, [])
            for k in range(1, len(corner) - 1):
                g.append((corner[0], corner[k], corner[k + 1]))

    vs = np.asarray(vs, np.float32) * scale
    vns = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)
    vts = np.asarray(vts, np.float32) if vts else np.zeros((0, 2), np.float32)

    def fix(i, n):
        return i - 1 if i > 0 else n + i

    cache = {}
    n_tris = 0
    for mat_name, faces in groups.items():
        m = mtl.get(mat_name)
        mat_id = _make_material(builder, m, base_dir, cache) if m else -1
        emission = None
        if m and max(m["ke"]) > 0:
            emission = m["ke"]
        tris = np.asarray([[(fix(v, len(vs)), fix(t, len(vts)),
                             fix(n, len(vns))) for (v, t, n) in f]
                           for f in faces], np.int64)   # [F,3,3]
        pos = vs[tris[..., 0]].reshape(-1, 3)            # [F*3,3]
        idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
        has_n = len(vns) and (tris[..., 2] >= 0).all() \
            and (tris[..., 2] < len(vns)).all() and tris[..., 2].max() > 0
        normals = vns[tris[..., 2]].reshape(-1, 3) if has_n else None
        has_t = len(vts) and (tris[..., 1] < len(vts)).all() \
            and tris[..., 1].max() > 0
        uvs = vts[tris[..., 1]].reshape(-1, 2) if has_t else None
        builder.add_mesh(pos, idx, normals=normals, uvs=uvs,
                         material=mat_id, emission=emission,
                         transform=transform)
        n_tris += len(tris)
    return dict(n_tris=n_tris, n_materials=len(mtl))
