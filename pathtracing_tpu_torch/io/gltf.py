"""glTF 2.0 loader (counterpart of pathtracing_tpu/io/gltf.py; pure
Python and NumPy).

Parses .gltf / .glb directly (JSON, binary buffers, data URIs; images
through Pillow, imported only when a material has one), walks the node
hierarchy accumulating transforms (pre-applied to the vertices) and emits
meshes, materials and textures into a SceneBuilder.  Accessors are read
as NumPy views of the buffers (strided ones too), so a model of millions
of triangles loads in seconds.

Material inference, as the reference package does it:
  alphaMode OPAQUE / BLEND / MASK + alphaCutoff
  KHR_materials_transmission > 0 -> dielectric (thin when the
      KHR_materials_volume thickness is 0)
  otherwise                      -> diffuse (metallic-roughness)
  emissiveFactor x KHR_materials_emissive_strength, emissiveTexture ->
      per-triangle area lights
  KHR_materials_volume attenuation -> homogeneous medium,
      sigma_a = -log(color) / distance
"""
from __future__ import annotations

import base64
import io as _io
import json
import math
import struct
from pathlib import Path

import numpy as np

from ..scene.types import ALPHA_OPAQUE, ALPHA_BLEND, ALPHA_MASK

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
              "MAT4": 16}


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    gltf_json, bin_chunk = None, None
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8: off + 8 + clen]
        if ctype == 0x4E4F534A:
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:
            bin_chunk = chunk
        off += 8 + clen
    return gltf_json, bin_chunk


def _load_buffers(g, base_dir: Path, bin_chunk):
    bufs = []
    for b in g.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote
            bufs.append((base_dir / unquote(uri)).read_bytes())
    return bufs


def _accessor(g, bufs, idx):
    """Decode accessor `idx` into a NumPy array [count, size]."""
    a = g["accessors"][idx]
    count = a["count"]
    size = _TYPE_SIZE[a["type"]]
    dtype = _COMPONENT_DTYPE[a["componentType"]]
    if "bufferView" not in a:
        out = np.zeros((count, size), dtype)
    else:
        bv = g["bufferViews"][a["bufferView"]]
        buf = bufs[bv["buffer"]]
        start = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        itemsize = np.dtype(dtype).itemsize * size
        if stride and stride != itemsize:
            # interleaved attributes: a strided view of the buffer
            out = np.ndarray((count, size), dtype, buffer=buf, offset=start,
                             strides=(stride, np.dtype(dtype).itemsize)
                             ).copy()
        else:
            out = np.frombuffer(buf, dtype, count * size,
                                start).reshape(count, size).copy()
    if a.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _decode_image(g, bufs, base_dir: Path, img_index, srgb: bool):
    from PIL import Image
    img = g["images"][img_index]
    if "uri" in img and not img["uri"].startswith("data:"):
        from urllib.parse import unquote
        pil = Image.open(base_dir / unquote(img["uri"]))
    else:
        if "uri" in img:
            raw = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            bv = g["bufferViews"][img["bufferView"]]
            buf = bufs[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            raw = buf[start:start + bv["byteLength"]]
        pil = Image.open(_io.BytesIO(raw))
    pil = pil.convert("RGBA")
    arr = np.asarray(pil, np.float32) / 255.0
    if srgb:
        rgb = arr[..., :3]
        arr[..., :3] = np.where(rgb <= 0.04045, rgb / 12.92,
                                ((rgb + 0.055) / 1.055) ** 2.4)
    # glTF uses top-left UV origin; the texture pool samples bottom-left
    return arr[::-1]


def load_gltf(path, builder, scale: float = 1.0, transform=None):
    """Load a .gltf/.glb file into `builder` (SceneBuilder).

    Returns a dict with the lists of created material/texture ids.
    Node transforms are pre-applied to vertices (the reference uses
    aiProcess_PreTransformVertices for the same effect, Model.cpp:50).
    """
    path = Path(path)
    base_dir = path.parent
    if path.suffix.lower() == ".glb":
        g, bin_chunk = _read_glb(path.read_bytes())
    else:
        g = json.loads(path.read_text())
        bin_chunk = None
    bufs = _load_buffers(g, base_dir, bin_chunk)

    # ---- textures (lazily decoded, cached per (image, srgb))
    tex_cache = {}

    def get_tex(tex_info, srgb):
        if tex_info is None:
            return -1
        t = g["textures"][tex_info["index"]]
        img_index = t.get("source", -1)
        if img_index < 0:
            return -1
        key = (img_index, srgb)
        if key not in tex_cache:
            arr = _decode_image(g, bufs, base_dir, img_index, srgb)
            tex_cache[key] = builder.textures.add_image(arr)
        return tex_cache[key]

    # ---- materials (Model.cpp:123-192 inference)
    mat_ids, mat_emissive, mat_medium = [], [], []
    for m in g.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base_factor = pbr.get("baseColorFactor", [1, 1, 1, 1])
        base_tex = get_tex(pbr.get("baseColorTexture"), srgb=True)
        mr_tex = get_tex(pbr.get("metallicRoughnessTexture"), srgb=False)
        norm_tex = get_tex(m.get("normalTexture"), srgb=False)
        rough = float(pbr.get("roughnessFactor", 1.0))
        metal = float(pbr.get("metallicFactor", 1.0))
        mode = {"OPAQUE": ALPHA_OPAQUE, "BLEND": ALPHA_BLEND,
                "MASK": ALPHA_MASK}[m.get("alphaMode", "OPAQUE")]
        cutoff = float(m.get("alphaCutoff", 0.5))
        ext = m.get("extensions", {})
        ior = float(ext.get("KHR_materials_ior", {}).get("ior", 1.5))
        transmission = float(ext.get("KHR_materials_transmission", {})
                             .get("transmissionFactor", 0.0))
        volume = ext.get("KHR_materials_volume", {})
        thickness = float(volume.get("thicknessFactor", 0.0))

        base_rgb = tuple(base_factor[:3])
        if transmission > 0.0:
            if thickness == 0.0:
                mid = builder.add_thin_dielectric(ior=ior,
                                                  base_color=base_rgb,
                                                  base_tex=base_tex)
            else:
                mid = builder.add_dielectric(
                    ior=ior, roughness=rough, base_color=base_rgb,
                    base_tex=base_tex, rough_tex=mr_tex,
                    norm_tex=norm_tex, alpha_mode=mode, alpha_cutoff=cutoff)
        else:
            mid = builder.add_diffuse(
                base_color=base_rgb, roughness=rough, metallic=metal,
                base_tex=base_tex, rough_tex=mr_tex, metal_tex=mr_tex,
                norm_tex=norm_tex,
                alpha_tex=base_tex if mode != ALPHA_OPAQUE else -1,
                alpha_mode=mode, alpha_cutoff=cutoff)
        mat_ids.append(mid)

        em_factor = np.asarray(m.get("emissiveFactor", [0, 0, 0]),
                               np.float32)
        strength = float(ext.get("KHR_materials_emissive_strength", {})
                         .get("emissiveStrength", 1.0))
        em_tex = get_tex(m.get("emissiveTexture"), srgb=True)
        mat_emissive.append((em_factor * strength, em_tex))

        # volume extension -> homogeneous medium (Model.cpp:342-351)
        med = -1
        att_dist = float(volume.get("attenuationDistance", math.inf))
        if thickness > 0.0 and math.isfinite(att_dist):
            att_color = np.asarray(volume.get("attenuationColor", [1, 1, 1]),
                                   np.float32)
            sigma_a = -np.log(np.maximum(att_color, 1e-4)) / att_dist
            med = builder.add_medium(sigma_a=sigma_a, sigma_s=(0, 0, 0))
        mat_medium.append(med)

    root_tf = np.eye(4, dtype=np.float32) if transform is None \
        else np.asarray(transform, np.float32)
    root_tf = root_tf @ np.diag([scale, scale, scale, 1.0]).astype(np.float32)

    n_meshes = 0

    def emit_mesh(mesh_index, world):
        nonlocal n_meshes
        mesh = g["meshes"][mesh_index]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:      # triangles only
                continue
            attrs = prim["attributes"]
            pos = _accessor(g, bufs, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor(g, bufs, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos))
            idx = idx.astype(np.int32).reshape(-1, 3)
            normals = _accessor(g, bufs, attrs["NORMAL"]).astype(np.float32) \
                if "NORMAL" in attrs else None
            uvs = _accessor(g, bufs, attrs["TEXCOORD_0"]).astype(np.float32) \
                if "TEXCOORD_0" in attrs else None
            if uvs is not None:
                # texture pool uses bottom-left origin; images were flipped
                uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], -1)
            tans = None
            if "TANGENT" in attrs:
                # xyz only; bitangent handedness (w) is dropped — the ONB
                # derives b = cross(ns, t), correct for w=+1 assets
                t4 = _accessor(g, bufs, attrs["TANGENT"]).astype(np.float32)
                tans = t4[:, :3]
            mi = prim.get("material", -1)
            mat = mat_ids[mi] if mi >= 0 else -1
            emission, em_tex = (None, -1)
            med = -1
            if mi >= 0:
                em, et = mat_emissive[mi]
                if np.any(em > 0) or et >= 0:
                    emission, em_tex = tuple(em), et
                med = mat_medium[mi]
            builder.add_mesh(pos, idx, normals=normals, uvs=uvs,
                             tangents=tans, material=mat, medium=med,
                             emission=emission, em_tex=em_tex,
                             transform=world)
            n_meshes += 1

    def walk(node_index, parent):
        node = g["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)
        for c in node.get("children", []):
            walk(c, world)

    scene_idx = g.get("scene", 0)
    roots = g.get("scenes", [{}])[scene_idx].get("nodes", [])
    if roots:
        for r in roots:
            walk(r, root_tf)
    else:
        for i in range(len(g.get("nodes", []))):
            walk(i, root_tf)

    return dict(materials=mat_ids, n_meshes=n_meshes,
                n_textures=len(tex_cache))
