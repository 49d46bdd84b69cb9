"""Carry a scene built by the reference JAX package into this package.

`from_numpy_scene` takes the reference package's scene dict, camera dict
and SceneMeta fields as NumPy arrays and plain Python values (for
example `{k: np.asarray(v) for k, v in scene.items()}`, the same for the
camera, and `dataclasses.asdict(meta)`) and returns this package's
(scene, cam, SceneMeta) on `device`.  Nothing of the JAX package is
imported: the caller does the NumPy conversion.

Geometry, material, texture, light (environment tables and emission
textures included) and media tables carry over as they are, the run-time instance tables (otri_*, inst_*, ilight_map) and the
velocities (*_vel) included.  The reference's traversal tables are laid
out for its TPU kernels, so for a meta.accel == "pallas" scene the
tables (single- or two-level as the reference scene has them, plain or
instanced, the opaque / alpha split, the alpha micro-mask words and the
motion rows included) are rebuilt here from the carried triangles,
instances, materials and textures with this package's own builder code
(same SAH builder, same order).  A meta.accel == "beam" scene keeps its
block cut and its component-first prim tables as they are (plain arrays,
read by accel/beam.py), and a meta.accel == "bvh" scene its wide-node
arrays besides (read by accel/traverse.py).  Any other accel becomes the
brute scan, which returns the same hits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import resolve_device
from .scene.types import SceneMeta

_SCENE_KEYS = (
    "tri_v", "tri_n", "tri_uv", "tri_tan", "tri_prop", "tri_pack",
    "sph_c", "sph_r", "sph_prop",
    "quad_q", "quad_u", "quad_v", "quad_n", "quad_d", "quad_w", "quad_prop",
    "mat_type", "mat_base", "mat_rough", "mat_metal", "mat_ior",
    "mat_tex", "mat_alpha_mode", "mat_alpha_cutoff",
    "tex_texels", "tex_info_i", "tex_info_f",
    "light_type", "light_color", "light_vec", "light_shape", "light_flags",
    "light_area", "light_power", "light_cdf", "light_total_power",
    "inf_idx", "scene_lo", "scene_hi", "light_emtex", "light_env_slot",
    "env_weights", "env_cdf", "env_total")
_INST_KEYS = ("otri_v", "otri_n", "otri_uv", "otri_tan", "otri_prop",
              "inst_fwd", "inst_inv", "inst_nrm", "inst_base", "inst_count",
              "inst_slot_base", "inst_vel", "ilight_map")
_MOTION_KEYS = ("tri_vel", "sph_vel", "quad_vel")
# the media table: (key, shape of its one padding row when absent)
_MEDIA_KEYS = (("med_sigma_a", (1, 3)), ("med_sigma_s", (1, 3)),
               ("med_g", (1,)), ("med_le", (1, 3)))
_BEAM_KEYS = ("blk_lo", "blk_hi", "blk_base", "blk_k", "prim_kind",
              "prim_idx", "beam_tri", "beam_sph", "beam_quad")
_BVH_KEYS = ("bvh_lo", "bvh_hi", "bvh_child")
_CAM_KEYS = ("origin", "u", "v", "w", "half_wh", "defocus_radius",
             "focus_distance", "shutter")


def from_numpy_scene(scene: dict, cam: dict, meta_fields: dict, device=None):
    """(scene, cam, meta) of the reference package, as NumPy / Python
    values -> this package's (scene, cam, SceneMeta) on `device`."""
    dev = resolve_device(device)
    arrays = {k: np.asarray(scene[k]) for k in _SCENE_KEYS
              if k in scene and k != "tri_pack"}
    n_tri = int(meta_fields.get("n_tri", 0))
    n_inst = int(meta_fields.get("n_inst", 0))
    motion = bool(meta_fields.get("has_motion"))
    if n_inst:
        arrays.update({k: np.asarray(scene[k]) for k in _INST_KEYS})
    if motion:
        arrays.update({k: np.asarray(scene[k], np.float32)
                       for k in _MOTION_KEYS})
    for k, shape in _MEDIA_KEYS:
        arrays[k] = (np.asarray(scene[k], np.float32) if k in scene
                     else np.zeros(shape, np.float32))
    arrays["med_sigma_t"] = arrays["med_sigma_a"] + arrays["med_sigma_s"]
    if meta_fields.get("has_light_motion"):
        arrays["light_vel"] = np.asarray(scene["light_vel"], np.float32)
    if "tri_pack" in scene:
        arrays["tri_pack"] = np.asarray(scene["tri_pack"], np.float32)
    else:
        nt = len(arrays["tri_v"])
        arrays["tri_pack"] = np.concatenate([
            arrays["tri_v"].reshape(nt, 9), arrays["tri_n"].reshape(nt, 9),
            arrays["tri_uv"].reshape(nt, 6),
            arrays["tri_prop"].astype(np.float32),
            np.zeros((nt, 4), np.float32)], 1)

    names = {f.name for f in dataclasses.fields(SceneMeta)}
    fields = {k: v for k, v in meta_fields.items() if k in names}
    for k in ("mats_present", "mat_tex_present"):
        if k in fields:
            fields[k] = tuple(bool(x) for x in fields[k])
    accel = fields.get("accel", "brute")
    block_g = int(fields.get("block_g", 16))
    if accel == "pallas" and (n_tri or n_inst):
        from .scene.builder import build_traversal_tables
        from .scene.textures import TexturePool
        n_mat = int(fields.get("n_mat", 0))
        pool = TexturePool.from_packed(
            arrays["tex_texels"], arrays["tex_info_i"], arrays["tex_info_f"])
        inst = None
        if n_inst:
            inst = dict(otri_v=arrays["otri_v"], otri_uv=arrays["otri_uv"],
                        otri_mat=arrays["otri_prop"][:, 0],
                        fwd=arrays["inst_fwd"], inv=arrays["inst_inv"],
                        base=arrays["inst_base"], count=arrays["inst_count"],
                        vel=arrays["inst_vel"])
        pk, block_k, alpha_block_k, alpha_cull_mask = build_traversal_tables(
            np.asarray(arrays["tri_v"][:n_tri], np.float32),
            arrays["tri_uv"][:n_tri], arrays["tri_prop"][:n_tri, 0], pool,
            arrays["mat_alpha_mode"][:n_mat],
            arrays["mat_alpha_cutoff"][:n_mat], arrays["mat_tex"][:n_mat],
            block_g,
            tri_vel=arrays["tri_vel"][:n_tri] if motion else None,
            shutter=tuple(float(x) for x in np.asarray(cam["shutter"])),
            inst=inst,
            two_level=(("pk_l1_base" in scene, "pka_l1_base" in scene)
                       if "pk_tri" in scene else None))
        arrays.update(pk)
        fields.update(accel="pallas", block_k=block_k, block_g=block_g,
                      alpha_block_k=alpha_block_k,
                      alpha_cull_mask=alpha_cull_mask)
    elif accel in ("beam", "bvh") and "blk_lo" in scene:
        keys = _BEAM_KEYS + (_BVH_KEYS if accel == "bvh" else ())
        arrays.update({k: np.asarray(scene[k]) for k in keys})
        fields.update(block_k=int(arrays["blk_k"][0]), alpha_block_k=0,
                      alpha_cull_mask=False)
    else:
        fields.update(accel="brute", block_k=0, alpha_block_k=0,
                      alpha_cull_mask=False)
    out_scene = {k: torch.from_numpy(np.array(v)).to(dev)
                 for k, v in arrays.items()}
    out_cam = {k: torch.from_numpy(np.array(cam[k], np.float32)).to(dev)
               for k in _CAM_KEYS}
    out_cam["resolution"] = tuple(int(x) for x in cam["resolution"])
    return out_scene, out_cam, SceneMeta(**fields)
