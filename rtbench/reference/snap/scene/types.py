"""Scene IR: static metadata + tensor conventions (counterpart of
pathtracing_tpu/scene/types.py).

A scene is a dict of tensors (geometry, material, light tables) plus this
frozen `SceneMeta`.  Array schema (float32 / int32), ids -1 for "none",
every table padded to >= 1 row so gathers stay well-formed:
  tri_v   [T,3,3]  vertices                 tri_n   [T,3,3] shading normals
  tri_uv  [T,3,2]  texcoords                tri_prop[T,4]  (mat, light,
                                                            medium, has_tan)
  tri_pack[T,32]   verts 9 | normals 9 | uvs 6 | prop 4 | pad 4
  tri_tan [T,3,3]  authored tangents (zeros where a mesh has none)
  sph_c   [S,3], sph_r [S], sph_prop [S,3]
  quad_q/u/v/n [Q,3], quad_d [Q], quad_w [Q,3], quad_prop [Q,3]
  mat_type[M], mat_base[M,3], mat_rough[M], mat_metal[M], mat_ior[M]
  mat_tex [M,5] i32 (base, rough, metal, normal, alpha texture ids),
  mat_alpha_mode[M] i32, mat_alpha_cutoff[M]
  tex_texels[NT,4], tex_info_i[K,6] i32, tex_info_f[K,8] (textures.py)
  light_type[L], light_color[L,3], light_vec[L,3], light_shape[L,2],
  light_flags[L], light_area[L], light_power[L], light_cdf[L],
  light_total_power[1], inf_idx[LI] (uniform-infinite and env lights),
  light_emtex[L] emission / env texture id (-1: flat), light_env_slot[L]
  the env light's table row (-1: not an env light)
  env_weights / env_cdf [E, nx*ny], env_total [E]  per-env-light luminance
        importance tables over the (z, azimuth) grid, cell ix * ny + iy
        (one padding row when meta.n_env == 0)
  med_sigma_a/s/t [D,3], med_g [D], med_le [D,3]  homogeneous media
        (absorption, scattering, extinction, HG asymmetry, emission);
        prop column 2 of a shape is the medium on the side its normal
        faces away from (-1: none)
  tri_vel [T,3], sph_vel [S,3], quad_vel [Q,3], light_vel [L,3]  linear
        velocities (position at ray time t is position + velocity * t)
  run-time instances (only when meta.n_inst > 0):
  otri_v / otri_n / otri_tan [O,3,3], otri_uv [O,3,2], otri_prop [O,4]
        object-space triangles of the instanced models, each model once
  inst_fwd / inst_inv [I,3,4] object-to-world / world-to-object affine,
  inst_nrm [I,3,3] inverse transpose (normals), inst_base / inst_count [I]
        the instance's range of otri_*, inst_vel [I,3],
  inst_slot_base [I], ilight_map [*]  light id of a hit on (instance i,
        object triangle o) = ilight_map[inst_slot_base[i] + o - base_i]
  pk_*  traversal tables: the two-level ones (accel/trace2.py, with
        "pk_l1_base") or the single-level ones (accel/trace1.py); when
        some but not all triangles have an alpha material, pk_* covers
        the opaque ones and pka_* the alpha ones, with pka_mask the
        per-slot micro-mask words (alphamask.py)
  blk_*, prim_kind / prim_idx, beam_*  the beam backend's block cut and
        prim tables (accel/beam.py; meta.accel == "beam" or "bvh")
  bvh_lo / bvh_hi / bvh_child  the wide BVH's nodes (accel/traverse.py;
        meta.accel == "bvh")
A hit on a run-time instance has kind SHAPE_ITRI and idx = instance *
meta.n_obj_tri + object triangle.
"""
from __future__ import annotations

import dataclasses

MAT_NONE = -1

LIGHT_UNIFORM_INF = 0
LIGHT_ENV_TEX = 1
LIGHT_DISTANT = 2
LIGHT_POINT = 3
LIGHT_AREA = 4

SHAPE_TRI = 0
SHAPE_SPH = 1
SHAPE_QUAD = 2
SHAPE_ITRI = 3   # triangle of a run-time instance

ALPHA_OPAQUE = 0
ALPHA_BLEND = 1
ALPHA_MASK = 2


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Same fields as the reference package's SceneMeta, so a scene built
    there carries across (convert.from_numpy_scene)."""
    n_tri: int = 0
    n_sph: int = 0
    n_quad: int = 0
    n_mat: int = 0
    n_lights: int = 0
    n_inf: int = 0
    n_media: int = 0
    env_nx: int = 0
    env_ny: int = 0
    n_env: int = 0
    scene_medium: int = -1
    camera_medium: int = -1
    has_alpha: bool = False
    light_sampler: str = "power"  # "power" | "uniform"
    accel: str = "brute"      # "pallas" (kernels) | "beam" | "bvh" | "brute"
    block_k: int = 0              # triangles per (child) block of pk_*
    #                               (beam: prims per block)
    block_g: int = 16             # G: child blocks per L1 superblock
    block_pops: int = 1
    alpha_block_k: int = 0
    has_motion: bool = False
    has_light_motion: bool = False
    n_inst: int = 0
    n_obj_tri: int = 0
    mats_present: tuple = (True, True, True, True)  # diffuse/diel/thin/cond
    has_tangents: bool = False
    has_normal_maps: bool = False
    mat_tex_present: tuple = (False, False, False, False, False)
    has_emissive_tex: bool = False
    analytic_alpha: bool = False
    alpha_cull_mask: bool = False
