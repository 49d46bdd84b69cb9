"""Host-side scene builder (counterpart of pathtracing_tpu/scene/builder.py).

Same API for the features this package runs: the texture pool,
materials (diffuse, dielectric, thin dielectric, conductor) with base /
roughness / metallic / normal / alpha textures and alpha modes, spheres,
quads and triangle meshes with uvs and authored tangents (emissive ones
become area lights, with a flat or a textured emission), models instanced
as world triangles or kept as run-time instances (with per-instance area
lights for emissive models), linear motion (`velocity=` on shapes,
meshes, instances and point lights, `set_camera(shutter=)`),
uniform-infinite, environment-map (from a texture, an image file or a
function of direction, each with its own importance table), distant and
point lights, homogeneous media and the camera.  `build()` packs NumPy tables
into torch tensors on the device and returns (scene, cam, SceneMeta).
This frozen copy builds no traversal tables (accel is always "brute"): the
reference traverses with its own scan.
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.bsdf import (MAT_DIFFUSE, MAT_DIELECTRIC, MAT_THIN_DIELECTRIC,
                         MAT_CONDUCTOR)
from .textures import TexturePool
from .types import (SceneMeta, LIGHT_UNIFORM_INF, LIGHT_ENV_TEX, LIGHT_DISTANT,
                    LIGHT_POINT, LIGHT_AREA, SHAPE_TRI, SHAPE_SPH, SHAPE_QUAD,
                    SHAPE_ITRI, ALPHA_OPAQUE)

FLATTEN_MAX = 4_000_000   # runtime="auto" instances above this many
                          # expanded triangles stay run-time instances; the
                          # environment variable PT_FLATTEN_MAX, read at
                          # build(), overrides it (0 keeps them all)

_LUM_W = (0.2126, 0.7152, 0.0722)


def _lum(c):
    return float(np.dot(np.asarray(c, np.float64), _LUM_W))


def _moves(velocity) -> bool:
    return bool(np.abs(np.asarray(velocity, np.float32)).max() > 0)


def _table_sphere_uv(d):
    """core.math.sphere_uv of the env tables' cell-centre directions [K,3]
    (CPU float32), evaluated as the reference package's builder evaluates
    it, one operation at a time: |d|^2 summed in order, no fused
    multiply-add, acos(y) as atan2(sqrt((1 - y)(1 + y)), y), so the
    tables equal the reference's bit for bit."""
    from ..core.math import INV_PI, fatan2, fsqrt
    n2 = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])[:, None]
    pos = n2 > 1e-12
    p = torch.where(pos, d / fsqrt(torch.where(pos, n2, 1.0)), d)
    y = torch.clamp(p[:, 1], -1.0, 1.0)
    theta = fatan2(fsqrt((1.0 - y) * (1.0 + y)), y)
    phi = fatan2(p[:, 2], p[:, 0])
    phi = torch.where(phi < 0, phi + 2.0 * np.pi, phi)
    return torch.stack([phi * (0.5 * INV_PI), theta * INV_PI], -1)


class _ChunkedRows:
    """Row table that keeps bulk appends as whole chunks and concatenates
    lazily (a Python list of 10M row views is minutes of np.asarray)."""

    def __init__(self):
        self._chunks = []
        self._n = 0

    def append(self, row):
        self._chunks.append(np.asarray(row)[None])
        self._n += 1

    def extend(self, rows):
        rows = np.asarray(rows)
        if len(rows):
            self._chunks.append(rows)
            self._n += len(rows)

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def _cat(self):
        if not self._chunks:
            return np.zeros((0,), np.float32)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks, 0)]
        return self._chunks[0]

    def __array__(self, dtype=None, copy=None):
        a = self._cat()
        return a.astype(dtype) if dtype is not None and a.dtype != dtype else a

    def __getitem__(self, i):
        return self._cat()[i]


def alpha_material_mask(mats, mat_modes):
    """Which of the material ids `mats` name an alpha (non-opaque)
    material; out-of-range ids (-1) do not."""
    mats = np.asarray(mats, np.int64)
    mat_modes = np.asarray(mat_modes, np.int64)
    out = np.zeros(len(mats), bool)
    if len(mats) and len(mat_modes):
        ok = (mats >= 0) & (mats < len(mat_modes))
        out[ok] = mat_modes[mats[ok]] != ALPHA_OPAQUE
    return out


def _accumulate_vertex_normals(vertices, indices):
    """Area-weighted vertex normals via bincount."""
    e1 = vertices[indices[:, 1]] - vertices[indices[:, 0]]
    e2 = vertices[indices[:, 2]] - vertices[indices[:, 0]]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = np.zeros_like(vertices)
    nv = len(vertices)
    for k in range(3):
        for c in range(3):
            normals[:, c] += np.bincount(indices[:, k], weights=fn[:, c],
                                         minlength=nv)[:nv]
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True),
                          1e-20)
    return normals.astype(np.float32)


class SceneBuilder:
    def __init__(self):
        self.textures = TexturePool()
        self._mat = dict(type=[], base=[], rough=[], metal=[], ior=[],
                         tex=[], alpha_mode=[], alpha_cutoff=[])
        # vel: linear velocity (position at ray time t = position + vel * t)
        self._tri = {k: _ChunkedRows()
                     for k in ("v", "n", "uv", "tan", "prop", "vel")}
        self._models = []
        self._model_dedup = {}
        # run-time instances: object-space triangles, each model once, and
        # one dict per instance (transforms, range, lights, velocity)
        self._obj = {k: _ChunkedRows()
                     for k in ("v", "n", "uv", "tan", "prop")}
        self._obj_range = {}       # model id -> (first object triangle, count)
        self._inst = []
        self._sph = {k: _ChunkedRows() for k in ("c", "r", "prop", "vel")}
        self._quad = {k: _ChunkedRows()
                      for k in ("q", "u", "v", "prop", "vel")}
        self._has_motion = False
        self._lights = []
        self._med = dict(sa=[], ss=[], g=[], le=[])
        self.scene_medium = -1
        self.camera = None
        self.light_sampler = "power"

    # -- materials ---------------------------------------------------------

    def _add_material(self, mtype, base, rough, metal, ior,
                      base_tex=-1, rough_tex=-1, metal_tex=-1, norm_tex=-1,
                      alpha_tex=-1, alpha_mode=ALPHA_OPAQUE,
                      alpha_cutoff=0.5) -> int:
        m = self._mat
        m["type"].append(mtype)
        m["base"].append(np.asarray(base, np.float32))
        m["rough"].append(float(rough))
        m["metal"].append(float(metal))
        m["ior"].append(float(ior))
        m["tex"].append([base_tex, rough_tex, metal_tex, norm_tex, alpha_tex])
        m["alpha_mode"].append(int(alpha_mode))
        m["alpha_cutoff"].append(float(alpha_cutoff))
        return len(m["type"]) - 1

    def add_diffuse(self, base_color=(0.8, 0.8, 0.8), roughness=1.0,
                    metallic=0.0, base_tex=-1, rough_tex=-1, metal_tex=-1,
                    norm_tex=-1, alpha_tex=-1, alpha_mode=ALPHA_OPAQUE,
                    alpha_cutoff=0.5) -> int:
        """Metallic-roughness diffuse with a GGX specular lobe."""
        return self._add_material(MAT_DIFFUSE, base_color, roughness,
                                  metallic, 1.5, base_tex, rough_tex,
                                  metal_tex, norm_tex, alpha_tex,
                                  alpha_mode, alpha_cutoff)

    def add_dielectric(self, ior=1.5, roughness=0.0, base_color=(1, 1, 1),
                       base_tex=-1, rough_tex=-1, norm_tex=-1, alpha_tex=-1,
                       alpha_mode=ALPHA_OPAQUE, alpha_cutoff=0.5) -> int:
        """Rough or smooth glass."""
        return self._add_material(MAT_DIELECTRIC, base_color, roughness, 0.0,
                                  ior, base_tex, rough_tex, -1, norm_tex,
                                  alpha_tex, alpha_mode, alpha_cutoff)

    def add_thin_dielectric(self, ior=1.5, base_color=(1, 1, 1),
                            base_tex=-1) -> int:
        """Thin glass slab."""
        return self._add_material(MAT_THIN_DIELECTRIC, base_color, 0.0, 0.0,
                                  ior, base_tex)

    def add_conductor(self, albedo=(0.9, 0.9, 0.9)) -> int:
        """Perfect mirror with Schlick Fresnel."""
        return self._add_material(MAT_CONDUCTOR, albedo, 0.0, 0.0, 1.0)

    # -- geometry ------------------------------------------------------------

    def _maybe_area_light(self, shape_kind, shape_idx, emission, em_tex,
                          one_sided) -> int:
        """An area light on the shape when it emits: a flat `emission` or
        the texture `em_tex` (which takes its place where set)."""
        if emission is None and em_tex < 0:
            return -1
        self._lights.append(dict(type=LIGHT_AREA,
                                 color=np.zeros(3, np.float32)
                                 if emission is None
                                 else np.asarray(emission, np.float32),
                                 vec=np.zeros(3, np.float32),
                                 shape=(shape_kind, shape_idx),
                                 emtex=int(em_tex), one_sided=bool(one_sided)))
        return len(self._lights) - 1

    def add_sphere(self, center, radius, material=-1, medium=-1,
                   emission=None, em_tex=-1, one_sided=False,
                   velocity=(0.0, 0.0, 0.0)) -> int:
        idx = len(self._sph["r"])
        lid = self._maybe_area_light(SHAPE_SPH, idx, emission, em_tex,
                                     one_sided)
        self._sph["c"].append(np.asarray(center, np.float32))
        self._sph["r"].append(float(radius))
        self._sph["prop"].append([material, lid, medium])
        self._sph["vel"].append(np.asarray(velocity, np.float32))
        self._has_motion |= _moves(velocity)
        return idx

    def add_quad(self, q, u, v, material=-1, medium=-1, emission=None,
                 em_tex=-1, one_sided=False,
                 velocity=(0.0, 0.0, 0.0)) -> int:
        idx = len(self._quad["q"])
        lid = self._maybe_area_light(SHAPE_QUAD, idx, emission, em_tex,
                                     one_sided)
        self._quad["q"].append(np.asarray(q, np.float32))
        self._quad["u"].append(np.asarray(u, np.float32))
        self._quad["v"].append(np.asarray(v, np.float32))
        self._quad["prop"].append([material, lid, medium])
        self._quad["vel"].append(np.asarray(velocity, np.float32))
        self._has_motion |= _moves(velocity)
        return idx

    def add_mesh(self, vertices, indices, normals=None, uvs=None,
                 tangents=None, material=-1, medium=-1, emission=None,
                 em_tex=-1, transform=None, emissive_power_cull=0.005,
                 velocity=(0.0, 0.0, 0.0)):
        """Flatten a triangle mesh into the global triangle table; emissive
        meshes get one area light per triangle above the power cull.
        transform: optional 4x4 object-to-world, applied here.  velocity:
        linear motion of the whole mesh over the shutter.  medium: the
        medium on the side the normals face away from (-1: none); a
        material-less mesh with a medium bounds a volume."""
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if transform is not None:
            tf = np.asarray(transform, np.float32)
            vertices = vertices @ tf[:3, :3].T + tf[:3, 3]
            nrm_mat = np.linalg.inv(tf[:3, :3]).T
        if normals is None:
            normals = _accumulate_vertex_normals(vertices, indices)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
            if transform is not None:
                normals = normals @ nrm_mat.T
                normals /= np.maximum(np.linalg.norm(normals, axis=-1,
                                                     keepdims=True), 1e-20)
        uvs = (np.asarray(uvs, np.float32).reshape(-1, 2) if uvs is not None
               else np.zeros((len(vertices), 2), np.float32))
        has_tan = tangents is not None
        tangents = (np.asarray(tangents, np.float32).reshape(-1, 3)
                    if has_tan else np.zeros_like(vertices))
        if has_tan and transform is not None:
            tangents = tangents @ tf[:3, :3].T

        first = len(self._tri["v"])
        f = len(indices)
        lids = np.full(f, -1, np.int64)
        em_lum = 0.0 if emission is None else _lum(emission)
        if (emission is not None and em_lum > 0) or em_tex >= 0:
            v0 = vertices[indices[:, 0]]
            e1 = vertices[indices[:, 1]] - v0
            e2 = vertices[indices[:, 2]] - v0
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            # a textured emitter counts with a 1e-6 luminance floor and is
            # never culled here
            powers = 2.0 * areas * max(em_lum, 1e-6 if em_tex >= 0 else 0)
            for t in np.nonzero((powers > emissive_power_cull)
                                | (em_tex >= 0))[0]:
                lids[t] = self._maybe_area_light(SHAPE_TRI, first + int(t),
                                                 emission, em_tex, False)
        self._tri["v"].extend(np.ascontiguousarray(vertices[indices],
                                                   np.float32))
        self._tri["n"].extend(np.ascontiguousarray(normals[indices],
                                                   np.float32))
        self._tri["uv"].extend(np.ascontiguousarray(uvs[indices], np.float32))
        self._tri["tan"].extend(np.ascontiguousarray(tangents[indices],
                                                     np.float32))
        props = np.empty((f, 4), np.int64)
        props[:, 0] = material
        props[:, 1] = lids
        props[:, 2] = medium
        props[:, 3] = 1 if has_tan else 0
        self._tri["prop"].extend(props)
        self._tri["vel"].extend(np.broadcast_to(
            np.asarray(velocity, np.float32), (f, 3)))
        self._has_motion |= _moves(velocity)
        return first, f

    # -- lights ---------------------------------------------------------------

    def _add_light(self, kind, color, vec=(0.0, 0.0, 0.0), emtex=-1,
                   **extra):
        self._lights.append(dict(type=kind, color=np.asarray(color,
                                                             np.float32),
                                 vec=np.asarray(vec, np.float32),
                                 shape=(-1, -1), emtex=int(emtex),
                                 one_sided=False, **extra))
        return len(self._lights) - 1

    def add_uniform_inf_light(self, color):
        return self._add_light(LIGHT_UNIFORM_INF, color)

    def add_distant_light(self, direction, color):
        return self._add_light(LIGHT_DISTANT, color, direction)

    def add_point_light(self, position, color, velocity=(0.0, 0.0, 0.0)):
        """velocity: the position at ray time t is position + velocity * t."""
        return self._add_light(LIGHT_POINT, color, position,
                               vel=np.asarray(velocity, np.float32))

    def add_env_light(self, tex_id: int, scale: float = 1.0):
        """Environment light: texture `tex_id` over the sphere_uv
        parameterisation, times `scale`, importance-sampled through its
        own luminance table (built at build())."""
        return self._add_light(LIGHT_ENV_TEX, np.full(3, scale, np.float32),
                               emtex=tex_id)

    def add_function_inf_light(self, fn, nx=512, ny=256, scale=1.0):
        """Procedural sky: `fn` maps directions [K,3] to rgb [K,3]
        (vectorised NumPy); it is baked to an nx x ny equirect texture and
        becomes an environment light."""
        xs = (np.arange(nx) + 0.5) / nx
        ys = (np.arange(ny) + 0.5) / ny
        u, v = np.meshgrid(xs, ys)              # [ny, nx]
        theta = np.pi * v
        phi = 2.0 * np.pi * u
        dirs = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                         np.sin(theta) * np.sin(phi)], -1).reshape(-1, 3)
        rgb = np.asarray(fn(dirs.astype(np.float32)),
                         np.float32).reshape(ny, nx, 3)
        return self.add_env_light(self.textures.add_image(rgb), scale=scale)

    # -- media ---------------------------------------------------------------

    def add_medium(self, sigma_a, sigma_s, g=0.0, density=1.0,
                   le=(0, 0, 0), le_density=1.0) -> int:
        """A homogeneous medium (absorption and scattering coefficients,
        Henyey-Greenstein g, emitted radiance); returns its id."""
        self._med["sa"].append(np.asarray(sigma_a, np.float32) * density)
        self._med["ss"].append(np.asarray(sigma_s, np.float32) * density)
        self._med["g"].append(float(g))
        self._med["le"].append(np.asarray(le, np.float32) * le_density)
        return len(self._med["g"]) - 1

    def set_scene_medium(self, medium_id: int):
        """The medium of the space outside every medium boundary."""
        self.scene_medium = medium_id

    # -- models & instancing ------------------------------------------------

    def add_model(self, vertices, indices, normals=None, uvs=None,
                  tangents=None, material=-1, medium=-1,
                  emission=None, em_tex=-1) -> int:
        """Register a reusable model; instance it with add_model_instance.
        Content-identical registrations share one model id."""
        h = hashlib.sha256()
        for a in (vertices, indices, normals, uvs, tangents):
            if a is None:
                h.update(b"\0none")
            else:
                arr = np.ascontiguousarray(np.asarray(a))
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
        key = (h.hexdigest(), int(material), int(medium),
               tuple(np.asarray(emission).tolist())
               if emission is not None else None, int(em_tex))
        if key in self._model_dedup:
            return self._model_dedup[key]
        self._models.append(dict(vertices=vertices, indices=indices,
                                 normals=normals, uvs=uvs,
                                 tangents=tangents, material=material,
                                 medium=medium, emission=emission,
                                 em_tex=int(em_tex)))
        self._model_dedup[key] = len(self._models) - 1
        return self._model_dedup[key]

    def add_model_instance(self, model_id: int, transform=None,
                           runtime: bool | str = False,
                           velocity=(0.0, 0.0, 0.0)):
        """Instance a registered model under a 4x4 object-to-world
        transform.

        runtime=False re-emits the geometry now as world triangles (it
        keeps its place in the triangle order).  runtime=True keeps a
        run-time instance: the model's object-space triangles are stored
        once and rays are inverse-transformed per instance at trace time
        (the traversal kernels' instanced mode, or the brute scan).
        runtime="auto" lets build() pick: such instances are re-emitted as
        world triangles after all other meshes when their total expanded
        size is at most FLATTEN_MAX triangles (PT_FLATTEN_MAX in the
        environment overrides it), else they stay run-time instances;
        instances of an emissive model always stay (each gets its own
        per-triangle area lights).  velocity: linear world-space motion of
        the whole instance over the shutter."""
        m = self._models[model_id]
        if not runtime:
            return self.add_mesh(m["vertices"], m["indices"],
                                 normals=m["normals"], uvs=m["uvs"],
                                 tangents=m["tangents"],
                                 material=m["material"], medium=m["medium"],
                                 emission=m["emission"], em_tex=m["em_tex"],
                                 transform=transform, velocity=velocity)
        if runtime is not True and runtime != "auto":
            raise ValueError(f"runtime must be False, True or 'auto', got "
                             f"{runtime!r}")
        if model_id not in self._obj_range:
            # register the object-space geometry once
            vertices = np.asarray(m["vertices"], np.float32).reshape(-1, 3)
            indices = np.asarray(m["indices"], np.int32).reshape(-1, 3)
            normals = (_accumulate_vertex_normals(vertices, indices)
                       if m["normals"] is None
                       else np.asarray(m["normals"], np.float32).reshape(-1, 3))
            uvs = (np.asarray(m["uvs"], np.float32).reshape(-1, 2)
                   if m["uvs"] is not None
                   else np.zeros((len(vertices), 2), np.float32))
            has_tan = m["tangents"] is not None
            tans = (np.asarray(m["tangents"], np.float32).reshape(-1, 3)
                    if has_tan else np.zeros_like(vertices))
            first = len(self._obj["v"])
            f = len(indices)
            for key, arr in (("v", vertices), ("n", normals), ("uv", uvs),
                             ("tan", tans)):
                self._obj[key].extend(np.ascontiguousarray(arr[indices],
                                                           np.float32))
            props = np.empty((f, 4), np.int64)
            props[:, 0] = m["material"]
            props[:, 1] = -1
            props[:, 2] = m["medium"]
            props[:, 3] = 1 if has_tan else 0
            self._obj["prop"].extend(props)
            self._obj_range[model_id] = (first, f)
        base, count = self._obj_range[model_id]
        tf = np.eye(4, dtype=np.float32) if transform is None \
            else np.asarray(transform, np.float32)
        inv = np.linalg.inv(tf)
        inst_idx = len(self._inst)
        # per-instance per-triangle area lights of an emissive model: each
        # names the shared object-space triangle and this instance
        light_first = -1
        emission, em_tex = m["emission"], m["em_tex"]
        if (emission is not None and _lum(emission) > 0) or em_tex >= 0:
            light_first = len(self._lights)
            color = (np.zeros(3, np.float32) if emission is None
                     else np.asarray(emission, np.float32))
            for j in range(count):
                self._lights.append(dict(
                    type=LIGHT_AREA, color=color,
                    vec=np.zeros(3, np.float32),
                    shape=(SHAPE_ITRI, -1),      # finalized in build()
                    emtex=em_tex, one_sided=False,
                    _inst=(inst_idx, base + j)))
        vel = np.asarray(velocity, np.float32)
        self._has_motion |= _moves(vel)
        self._inst.append(dict(
            fwd=tf[:3, :4], inv=inv[:3, :4],
            nrm=np.linalg.inv(tf[:3, :3]).T.astype(np.float32),
            base=base, count=count, light_first=light_first, vel=vel,
            model=model_id, tf4=tf,
            auto=(runtime == "auto" and light_first < 0)))
        return inst_idx

    def _maybe_flatten_instances(self):
        """Re-emit the runtime="auto" instances as world triangles when
        their total expanded size is small (see add_model_instance), and
        renumber the instances that stay in the deferred per-instance
        lights."""
        autos = [i for i, e in enumerate(self._inst) if e["auto"]]
        if not autos:
            return
        limit = int(os.environ.get("PT_FLATTEN_MAX", FLATTEN_MAX))
        if sum(self._inst[i]["count"] for i in autos) > limit:
            return
        for i in autos:
            e = self._inst[i]
            m = self._models[e["model"]]
            self.add_mesh(m["vertices"], m["indices"], normals=m["normals"],
                          uvs=m["uvs"], tangents=m["tangents"],
                          material=m["material"], medium=m["medium"],
                          transform=e["tf4"], velocity=e["vel"])
        flat = set(autos)
        keep = [i for i in range(len(self._inst)) if i not in flat]
        remap = {old: new for new, old in enumerate(keep)}
        self._inst = [self._inst[i] for i in keep]
        for lt in self._lights:
            if "_inst" in lt:        # emissive models are never flattened
                i, otri = lt["_inst"]
                lt["_inst"] = (remap[i], otri)

    # -- camera ------------------------------------------------------------

    def set_camera(self, look_from, look_at, fov, resolution,
                   focus_angle=0.0, focus_distance=0.0,
                   shutter=(0.0, 0.0), medium=-1):
        """Pinhole / thin-lens camera; fov in radians, half_width =
        tan(fov/2).  medium: the medium the camera sits in (-1: none)."""
        self.camera = dict(look_from=np.asarray(look_from, np.float32),
                           look_at=np.asarray(look_at, np.float32),
                           fov=float(fov), resolution=tuple(resolution),
                           focus_angle=float(focus_angle),
                           focus_distance=float(focus_distance),
                           shutter=tuple(shutter), medium=int(medium))

    # -- packing -----------------------------------------------------------

    def _scene_bounds(self):
        pts = []
        if self._tri["v"]:
            pts.append(np.asarray(self._tri["v"]).reshape(-1, 3))
        if self._sph["r"]:
            c = np.asarray(self._sph["c"])
            r = np.asarray(self._sph["r"])[:, None]
            pts += [c - r, c + r]
        if self._quad["q"]:
            q = np.asarray(self._quad["q"])
            u = np.asarray(self._quad["u"])
            v = np.asarray(self._quad["v"])
            pts += [q, q + u, q + v, q + u + v]
        live = [inst for inst in self._inst if inst["count"]]
        if live:
            # each model's object box once; then every instance's box
            # corners through its transform in one batched product (slice
            # by slice the product of one instance alone)
            boxes = {}
            for inst in live:
                key = (inst["base"], inst["count"])
                if key not in boxes:
                    ov = np.asarray(self._obj["v"][key[0]:key[0] + key[1]])
                    boxes[key] = (ov.reshape(-1, 3).min(0),
                                  ov.reshape(-1, 3).max(0))
            lo, hi = (np.stack([boxes[(i["base"], i["count"])][s]
                                for i in live]) for s in (0, 1))
            sel = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                            for z in (0, 1)], bool)
            corners = np.where(sel[None], hi[:, None], lo[:, None])
            fwd = np.stack([inst["fwd"] for inst in live])
            wc = corners @ fwd[:, :, :3].transpose(0, 2, 1) \
                + fwd[:, None, :, 3]
            pts.append(wc.reshape(-1, 3))
            moving = [k for k, inst in enumerate(live) if _moves(inst["vel"])]
            if moving:                         # union over the shutter
                sh = (self.camera or {}).get("shutter", (0.0, 0.0))
                vel = np.stack([live[k]["vel"] for k in moving])[:, None]
                pts += [(wc[moving] + vel * sh[0]).reshape(-1, 3),
                        (wc[moving] + vel * sh[1]).reshape(-1, 3)]
        if not pts:
            return np.zeros(3), np.ones(3)
        allp = np.concatenate(pts, 0)
        return allp.min(0), allp.max(0)

    def _shape_area(self, kind, idx) -> float:
        if kind == SHAPE_TRI:
            v = self._tri["v"][idx]
            return 0.5 * float(np.linalg.norm(
                np.cross(v[1] - v[0], v[2] - v[0])))
        if kind == SHAPE_SPH:
            return 4.0 * np.pi * self._sph["r"][idx] ** 2
        if kind == SHAPE_QUAD:
            return float(np.linalg.norm(np.cross(self._quad["u"][idx],
                                                 self._quad["v"][idx])))
        if kind == SHAPE_ITRI:
            # instanced triangle: world area under the instance transform
            i, otri = divmod(idx, max(len(self._obj["v"]), 1))
            f = self._inst[i]["fwd"]
            w = np.asarray(self._obj["v"][otri], np.float32) @ f[:, :3].T \
                + f[:, 3]
            return 0.5 * float(np.linalg.norm(
                np.cross(w[1] - w[0], w[2] - w[0])))
        return 0.0

    def _light_power(self, lt, scene_radius) -> float:
        """Light power with the reference's power-function defaults (an env
        light's from its table's mean luminance, a textured emitter's from
        its texture's, both set by build())."""
        kind = lt["type"]
        if kind in (LIGHT_UNIFORM_INF, LIGHT_DISTANT):
            return float(np.sum(lt["color"])) * np.sqrt(scene_radius)
        if kind == LIGHT_ENV_TEX:
            return (lt.get("_mean_lum", 1.0) * float(lt["color"][0])
                    * np.sqrt(scene_radius))
        if kind == LIGHT_POINT:
            return float(np.sum(lt["color"])) * 4.0 * scene_radius
        if kind == LIGHT_AREA:
            area = self._shape_area(*lt["shape"])
            em = (lt.get("_mean_em", 1.0) if lt["emtex"] >= 0
                  else _lum(lt["color"]))
            return (1.0 if lt["one_sided"] else 2.0) * area * em
        return 0.0

    def _build_env_tables(self, tex_arrays, nx=1024, ny=512):
        """Luminance importance tables over the (z, azimuth) grid, one per
        env light (every env light before the power cull, in order): the
        light's radiance at each cell centre.  Sets each env light's
        "_mean_lum" and "_env_slot".  Returns (tables or None, nx, ny)."""
        from .textures import texture_eval
        env = [lt for lt in self._lights if lt["type"] == LIGHT_ENV_TEX]
        if not env:
            return None, 0, 0
        us, vs = np.meshgrid((np.arange(nx) + 0.5) / nx,
                             (np.arange(ny) + 0.5) / ny, indexing="ij")
        uv = np.stack([us, vs], -1).reshape(-1, 2).astype(np.float32)
        z = 2.0 * uv[:, 0] - 1.0
        theta = 2.0 * np.pi * uv[:, 1]
        r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        dirs = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1)
        tex = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in tex_arrays.items()}
        suv = _table_sphere_uv(torch.from_numpy(dirs.astype(np.float32)))
        weights, cdfs, totals = [], [], []
        for slot, light in enumerate(env):
            ids = torch.full((len(uv),), light["emtex"], dtype=torch.int64)
            rgb = texture_eval(tex, ids, suv).numpy() * float(
                light["color"][0])
            lum = rgb @ np.asarray(_LUM_W, np.float32)
            light["_mean_lum"] = float(lum.mean())
            light["_env_slot"] = slot
            cdf = np.cumsum(lum.astype(np.float64))
            total = float(cdf[-1]) if cdf[-1] > 0 else 1.0
            weights.append(lum.astype(np.float32))
            cdfs.append((cdf / total).astype(np.float32))
            totals.append(total)
        return dict(env_weights=np.stack(weights), env_cdf=np.stack(cdfs),
                    env_total=np.asarray(totals, np.float32)), nx, ny

    def _set_emissive_means(self, tex_arrays):
        """Mean texel luminance of each textured emitter's image (1.0 for
        a texture with no texels: solid colours, checkers)."""
        for lt in self._lights:
            if lt["type"] == LIGHT_AREA and lt["emtex"] >= 0:
                info = tex_arrays["tex_info_i"][lt["emtex"]]
                texels = tex_arrays["tex_texels"][
                    info[1]:info[1] + info[2] * info[3], :3]
                lt["_mean_em"] = (float((texels @ np.asarray(_LUM_W)).mean())
                                  if len(texels) else 1.0)

    def build(self, power_cull: float = 0.01, accel: str = "auto",
              device=None):
        """Pack everything into (scene, cam, SceneMeta) on `device` (the GPU
        unless device="cpu").

        power_cull drops lights with power below it.  accel: "auto" picks
        "brute" under 4096 primitives (instanced triangles counted once
        per instance), "pallas" (the traversal tables that
        build_traversal_tables chooses) for triangle or instanced scenes
        above and "beam" (accel/beam.py) for the rest, as the reference
        package does; "bvh" builds the wide BVH (accel/traverse.py);
        "beam" or "bvh" on a moving or instanced scene warns and falls
        back to "brute"; "brute" forces the scan (and builds no alpha
        micro-masks: it is the unmasked oracle)."""
        dev = resolve_device(device)
        if accel not in ("auto", "pallas", "brute", "beam", "bvh"):
            raise ValueError(f"unknown accel {accel!r}")
        self._maybe_flatten_instances()
        n_inst = len(self._inst)
        n_obj_tri = len(self._obj["v"]) if n_inst else 0
        # per-instance area lights: the shape id needs the final size of
        # the object-space table
        for lt in self._lights:
            if "_inst" in lt:
                i, otri = lt["_inst"]
                lt["shape"] = (SHAPE_ITRI, i * max(n_obj_tri, 1) + otri)
        lo, hi = self._scene_bounds()
        center = 0.5 * (lo + hi)
        scene_radius = float(np.linalg.norm(hi - center)) or 1.0
        tex_arrays = self.textures.pack()
        env_tables, env_nx, env_ny = self._build_env_tables(tex_arrays)
        self._set_emissive_means(tex_arrays)

        powers = np.asarray([self._light_power(lt, scene_radius)
                             for lt in self._lights], np.float32)
        keep = powers >= power_cull
        remap = np.full(len(self._lights), -1, np.int32)
        remap[keep] = np.arange(int(keep.sum()), dtype=np.int32)
        lights = [lt for k, lt in zip(keep, self._lights) if k]
        powers = powers[keep]

        def remap_prop(props, width):
            props = (np.asarray(props, np.int32) if len(props)
                     else np.zeros((0, width), np.int32))
            if len(props):
                old = props[:, 1]
                mapped = (remap[np.clip(old, 0, len(remap) - 1)]
                          if len(remap) else np.full_like(old, -1))
                props[:, 1] = np.where(old >= 0, mapped, -1)
            return props

        tri_prop = remap_prop(self._tri["prop"], 4)
        sph_prop = remap_prop(self._sph["prop"], 3)
        quad_prop = remap_prop(self._quad["prop"], 3)

        # a hit on (instance i, object triangle o) finds its light id at
        # ilight_map[inst_slot_base[i] + (o - base_i)]
        inst_slot_base = np.full(max(n_inst, 1), -1, np.int32)
        ilight_slots: list = []
        for i, inst in enumerate(self._inst):
            lf = inst["light_first"]
            if lf >= 0:
                inst_slot_base[i] = len(ilight_slots)
                ilight_slots.extend(int(remap[lf + j])
                                    for j in range(inst["count"]))
        ilight_map = np.asarray(ilight_slots or [-1], np.int32)

        total_power = float(powers.sum())
        if self.light_sampler == "power" and total_power > 0:
            cdf = np.cumsum(powers.astype(np.float64)) / total_power
        else:
            n = max(len(lights), 1)
            cdf = (np.arange(n, dtype=np.float64) + 1) / n

        def pad(a, shape, dtype=np.float32, fill=0):
            a = np.asarray(a, dtype)
            return np.full(shape, fill, dtype) if a.size == 0 else a

        nt, ns, nq = len(self._tri["v"]), len(self._sph["r"]), \
            len(self._quad["q"])
        nm = len(self._mat["type"])

        quad_q = pad(self._quad["q"], (1, 3))
        quad_u = pad(self._quad["u"], (1, 3))
        quad_v = pad(self._quad["v"], (1, 3))
        qn_raw = np.cross(quad_u, quad_v)
        qn_len2 = np.maximum((qn_raw * qn_raw).sum(-1, keepdims=True), 1e-20)
        quad_n = qn_raw / np.sqrt(qn_len2)
        quad_d = (quad_n * quad_q).sum(-1)
        quad_w = qn_raw / qn_len2

        inf_idx = np.asarray([i for i, lt in enumerate(lights)
                              if lt["type"] in (LIGHT_UNIFORM_INF,
                                                LIGHT_ENV_TEX)], np.int32)
        tri_v = pad(self._tri["v"], (1, 3, 3))
        tri_n = pad(self._tri["n"], (1, 3, 3))
        tri_uv = pad(self._tri["uv"], (1, 3, 2))
        tri_tan = pad(self._tri["tan"], (1, 3, 3))
        tri_prop_p = pad(tri_prop, (1, 4), np.int32, -1)
        # packed per-triangle interaction row [T, 32]: one gather fetches
        # verts 9, shading normals 9, uvs 6, prop 4 (+4 pad)
        tri_pack = np.concatenate([
            tri_v.reshape(-1, 9), tri_n.reshape(-1, 9), tri_uv.reshape(-1, 6),
            tri_prop_p.astype(np.float32),
            np.zeros((len(tri_v), 4), np.float32)], 1)
        arrays = dict(
            tri_v=tri_v, tri_n=tri_n, tri_uv=tri_uv, tri_tan=tri_tan,
            tri_prop=tri_prop_p, tri_pack=tri_pack,
            sph_c=pad(self._sph["c"], (1, 3)),
            sph_r=pad(self._sph["r"], (1,)),
            sph_prop=pad(sph_prop, (1, 3), np.int32, -1),
            quad_q=quad_q, quad_u=quad_u, quad_v=quad_v, quad_n=quad_n,
            quad_d=quad_d, quad_w=quad_w,
            quad_prop=pad(quad_prop, (1, 3), np.int32, -1),
            mat_type=pad(self._mat["type"], (1,), np.int32, -1),
            mat_base=pad(self._mat["base"], (1, 3)),
            mat_rough=pad(self._mat["rough"], (1,)),
            mat_metal=pad(self._mat["metal"], (1,)),
            mat_ior=pad(self._mat["ior"], (1,), fill=1.5),
            mat_tex=pad(self._mat["tex"], (1, 5), np.int32, -1),
            mat_alpha_mode=pad(self._mat["alpha_mode"], (1,), np.int32),
            mat_alpha_cutoff=pad(self._mat["alpha_cutoff"], (1,), fill=0.5),
            light_type=pad([lt["type"] for lt in lights], (1,), np.int32, -1),
            light_color=pad([lt["color"] for lt in lights], (1, 3)),
            light_vec=pad([lt["vec"] for lt in lights], (1, 3)),
            # an instanced triangle's id (instance x n_obj_tri + object
            # triangle) passes 2^31 in a production-scale scene
            light_shape=pad([list(lt["shape"]) for lt in lights], (1, 2),
                            np.int64, -1),
            light_flags=pad([1 if lt["one_sided"] else 0 for lt in lights],
                            (1,), np.int32),
            light_emtex=pad([lt["emtex"] for lt in lights], (1,), np.int32,
                            -1),
            light_env_slot=pad([lt.get("_env_slot", -1) for lt in lights],
                               (1,), np.int32, -1),
            light_area=pad([self._shape_area(*lt["shape"])
                            if lt["type"] == LIGHT_AREA else 0.0
                            for lt in lights], (1,)),
            light_power=pad(powers, (1,)),
            light_cdf=pad(cdf, (1,), fill=1.0),
            light_total_power=np.asarray([total_power], np.float32),
            inf_idx=pad(inf_idx, (1,), np.int32, -1),
            med_sigma_a=pad(self._med["sa"], (1, 3)),
            med_sigma_s=pad(self._med["ss"], (1, 3)),
            med_g=pad(self._med["g"], (1,)),
            med_le=pad(self._med["le"], (1, 3)),
            scene_lo=np.asarray(lo, np.float32),
            scene_hi=np.asarray(hi, np.float32),
            **(env_tables or dict(env_weights=np.ones((1, 1), np.float32),
                                  env_cdf=np.ones((1, 1), np.float32),
                                  env_total=np.ones((1,), np.float32))),
            **tex_arrays,
        )
        arrays["med_sigma_t"] = arrays["med_sigma_a"] + arrays["med_sigma_s"]
        has_motion = self._has_motion
        has_light_motion = any(_moves(lt.get("vel", 0.0)) for lt in lights)
        if has_motion:
            arrays.update(tri_vel=pad(self._tri["vel"], (1, 3)),
                          sph_vel=pad(self._sph["vel"], (1, 3)),
                          quad_vel=pad(self._quad["vel"], (1, 3)))
        if has_light_motion:
            arrays["light_vel"] = pad(
                [lt.get("vel", np.zeros(3, np.float32)) for lt in lights],
                (1, 3))
        if n_inst:
            arrays.update(
                otri_v=np.asarray(self._obj["v"], np.float32),
                otri_n=np.asarray(self._obj["n"], np.float32),
                otri_uv=np.asarray(self._obj["uv"], np.float32),
                otri_tan=np.asarray(self._obj["tan"], np.float32),
                otri_prop=np.asarray(self._obj["prop"], np.int32),
                inst_fwd=np.stack([i["fwd"] for i in self._inst]),
                inst_inv=np.stack([i["inv"] for i in self._inst]),
                inst_nrm=np.stack([i["nrm"] for i in self._inst]),
                inst_base=np.asarray([i["base"] for i in self._inst],
                                     np.int32),
                inst_count=np.asarray([i["count"] for i in self._inst],
                                      np.int32),
                inst_slot_base=inst_slot_base,
                inst_vel=np.stack([i["vel"] for i in self._inst]),
                ilight_map=ilight_map)

        types_in_scene = set(int(t) for t in self._mat["type"])
        mats_present = tuple(bool(k in types_in_scene) or not types_in_scene
                             for k in range(4))
        mat_modes = np.asarray(self._mat["alpha_mode"], np.int64)
        has_alpha = bool((mat_modes != ALPHA_OPAQUE).any())
        analytic_alpha = bool(
            alpha_material_mask(sph_prop[:, 0], mat_modes).any()
            or alpha_material_mask(quad_prop[:, 0], mat_modes).any())
        mat_tex_np = (np.asarray(self._mat["tex"], np.int64)
                      if nm else np.zeros((0, 5), np.int64))
        block_k = alpha_block_k = 0
        alpha_cull_mask = False
        block_g = int(os.environ.get("PT_BLOCK_G", 32))
        block_pops = int(os.environ.get("PT_POPS", 4))
        n_inst_tris = sum(i["count"] for i in self._inst)
        n_prims = nt + ns + nq + n_inst_tris
        if accel == "auto":
            accel = ("brute" if n_prims < 4096 else
                     "pallas" if nt or n_inst else "beam")
        if has_motion and accel in ("beam", "bvh"):
            warnings.warn(f"accel={accel!r} does not support motion-"
                          "blurred scenes: falling back to accel='brute' "
                          "(use pallas for accelerated motion)", stacklevel=2)
            accel = "brute"
        if n_inst and accel in ("beam", "bvh"):
            warnings.warn(f"accel={accel!r} does not support runtime "
                          "instances: falling back to accel='brute' (use "
                          "pallas for accelerated instancing)", stacklevel=2)
            accel = "brute"
        accel = "brute"
        has_tangents = bool(nt and (tri_prop[:, 3] > 0).any())
        if n_inst and len(self._obj["prop"]):
            has_tangents = has_tangents or bool(
                (np.asarray(self._obj["prop"])[:, 3] > 0).any())

        scene = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in arrays.items()}
        meta = SceneMeta(
            n_tri=nt, n_sph=ns, n_quad=nq, n_mat=nm, n_lights=len(lights),
            n_inf=len(inf_idx), n_media=len(self._med["g"]),
            env_nx=env_nx, env_ny=env_ny,
            n_env=0 if env_tables is None else len(env_tables["env_total"]),
            scene_medium=self.scene_medium,
            camera_medium=(self.camera or {}).get("medium", -1),
            light_sampler=self.light_sampler,
            accel=accel, block_k=block_k, block_g=block_g,
            block_pops=block_pops,
            alpha_block_k=alpha_block_k, mats_present=mats_present,
            has_alpha=has_alpha, has_motion=has_motion,
            has_light_motion=has_light_motion, n_inst=n_inst,
            n_obj_tri=n_obj_tri, has_tangents=has_tangents,
            has_normal_maps=bool(nm and (mat_tex_np[:, 3] >= 0).any()),
            mat_tex_present=tuple(bool((mat_tex_np[:, s] >= 0).any())
                                  for s in range(5)),
            has_emissive_tex=any(lt["emtex"] >= 0 for lt in lights),
            analytic_alpha=analytic_alpha, alpha_cull_mask=alpha_cull_mask)
        return scene, self._pack_camera(dev), meta

    def _pack_camera(self, dev):
        """Camera basis."""
        if self.camera is None:
            raise ValueError("set_camera() was never called")
        c = self.camera
        w = c["look_from"] - c["look_at"]
        w = w / np.linalg.norm(w)
        u = np.cross([0.0, 1.0, 0.0], w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        half_w = np.tan(c["fov"] * 0.5)
        res = c["resolution"]
        half_h = half_w * res[1] / res[0]
        defocus_radius = c["focus_distance"] * np.tan(c["focus_angle"] / 2.0)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return dict(origin=f32(c["look_from"]), u=f32(u), v=f32(v), w=f32(w),
                    half_wh=f32([half_w, half_h]),
                    defocus_radius=f32(defocus_radius),
                    focus_distance=f32(c["focus_distance"]),
                    shutter=f32(c["shutter"]), resolution=c["resolution"])
