"""Frozen copy of pathtracing_tpu_torch/scenes.py::sanmiguel_analog.

The San-Miguel-class courtyard (a ~10.5M-triangle displaced terrain with
plateau buildings, four walls, 2,500 alpha-cutout shrubs, a glass and a
metal sphere, 20 emissive lamp meshes, sun and sky) as the port had it
when the benchmark was defined, written into a Recorder: the scene of a
cell stays the same whatever later changes make to the port's scenes.py.
`describe(**params)` returns the description; rtbench.scenedesc.replay
hands it to a SceneBuilder.
"""
from __future__ import annotations

import math

import numpy as np

from rtbench.scenedesc import Recorder


_SM_BLOCKS = ((22, 22, 9, 14), (70, 25, 11, 18), (28, 72, 10, 16),
              (72, 70, 8, 12), (50, 50, 6, 8))


def _sm_height(x, z):
    """Deterministic courtyard terrain height."""
    y = (2.5 * np.sin(x * 0.11) * np.cos(z * 0.09)
         + 0.8 * np.sin(x * 0.9 + 1.3) * np.sin(z * 1.1)
         + 0.15 * np.sin(x * 7.1) * np.cos(z * 6.3))
    for (bx, bz, hw, hh) in _SM_BLOCKS:
        mask = (np.abs(x - bx) < hw) & (np.abs(z - bz) < hw)
        y = np.where(mask, y + hh, y)
    return y.astype(np.float32)


def _sm_textures(b):
    """Procedural 1K plaster base + 512 normal map + 512 wall texture +
    256 leaf cutout: deterministic stand-ins for a heavily textured
    scene, of the same per-hit fetch cost."""
    n = 1024
    u, v = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n)
    plaster = np.empty((n, n, 3), np.float32)
    tone = (0.82 + 0.12 * np.sin(u * 37.0 + 2.0 * np.sin(v * 23.0))
            * np.cos(v * 41.0)
            + 0.06 * np.sin(u * 131.0) * np.sin(v * 119.0 + u * 57.0))
    grime = 0.10 * (np.sin(u * 9.0) * np.cos(v * 7.0) > 0.55)
    plaster[..., 0] = tone - grime
    plaster[..., 1] = tone * 0.92 - grime
    plaster[..., 2] = tone * 0.78 - grime
    base_tid = b.textures.add_image(np.clip(plaster, 0.02, 1.0))

    m = 512
    u, v = np.meshgrid((np.arange(m) + 0.5) / m, (np.arange(m) + 0.5) / m)
    h = (np.sin(u * 151.0) * np.cos(v * 137.0)
         + 0.5 * np.sin(u * 311.0 + v * 97.0))
    dhdx = np.gradient(h, axis=1) * m
    dhdy = np.gradient(h, axis=0) * m
    nrm = np.stack([-0.02 * dhdx, -0.02 * dhdy, np.ones_like(h)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    norm_tid = b.textures.add_image(((nrm + 1.0) * 0.5).astype(np.float32))

    brick_y = ((v * 24).astype(int))
    brick_x = ((u * 12 + 0.5 * (brick_y % 2)).astype(int))
    mortar = ((v * 24) % 1.0 < 0.08) | (((u * 12 + 0.5 * (brick_y % 2))
                                         % 1.0) < 0.04)
    wall = np.empty((m, m, 3), np.float32)
    bt = 0.55 + 0.25 * (((brick_x * 7 + brick_y * 13) % 5) / 4.0)
    wall[..., 0] = np.where(mortar, 0.75, bt)
    wall[..., 1] = np.where(mortar, 0.72, bt * 0.72)
    wall[..., 2] = np.where(mortar, 0.66, bt * 0.55)
    wall_tid = b.textures.add_image(wall)

    k = 256
    u, v = np.meshgrid((np.arange(k) + 0.5) / k, (np.arange(k) + 0.5) / k)
    leaf = np.zeros((k, k, 4), np.float32)
    # a leaf-shaped cutout: ellipse + serrated edge + central vein
    r2 = ((u - 0.5) / 0.38) ** 2 + ((v - 0.5) / 0.47) ** 2
    edge = 1.0 + 0.08 * np.sin(np.arctan2(v - 0.5, u - 0.5) * 14.0)
    inside = r2 < edge
    leaf[..., 0] = 0.10 + 0.08 * np.sin(v * 19.0)
    leaf[..., 1] = 0.35 + 0.20 * np.sin(u * 13.0 + v * 7.0)
    leaf[..., 2] = 0.08
    leaf[..., 3] = inside.astype(np.float32)
    leaf_tid = b.textures.add_image(leaf)
    return base_tid, norm_tid, wall_tid, leaf_tid


def _sm_foliage_model(rng, cards=48):
    """A shrub of `cards` crossed alpha-cutout cards (2 tris each) in a
    rough canopy: the foliage building block the scene instances by
    the thousands."""
    V, F, UV = [], [], []
    for _ in range(cards):
        cx, cy, cz = rng.normal(0, 0.45, 3)
        cy = abs(cy) * 0.9 + 0.3
        s = rng.uniform(0.35, 0.75)
        ry = rng.uniform(0, np.pi)
        tilt = rng.uniform(-0.4, 0.4)
        ux = np.asarray([np.cos(ry), 0.0, np.sin(ry)]) * s
        uy = np.asarray([-np.sin(ry) * np.sin(tilt), np.cos(tilt),
                         np.cos(ry) * np.sin(tilt)]) * s
        c = np.asarray([cx, cy, cz])
        i0 = len(V)
        V += [c - 0.5 * ux, c + 0.5 * ux, c + 0.5 * ux + uy,
              c - 0.5 * ux + uy]
        UV += [[0, 0], [1, 0], [1, 1], [0, 1]]
        F += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    return (np.asarray(V, np.float32), np.asarray(F, np.int32),
            np.asarray(UV, np.float32))


def describe(resolution=(1920, 1080), n_tris=10_500_000, accel="auto",
             faithful=True, foliage=2500):
    """San-Miguel-class synthetic workload.

    A synthetic analog of a ~10M-triangle, heavily textured courtyard
    scene full of instanced alpha-masked foliage:

      * a walled courtyard whose floor is a ~n_tris-triangle displaced
        grid with plateau "buildings" (local occlusion, deep paths),
        textured (1K base + normal map);
      * `foliage` instances of a 96-triangle alpha-MASK shrub model,
        added with runtime="auto": re-emitted as world triangles at build
        time by default, kept as run-time instances (the shrub stored
        once, instanced two-level alpha tables) with PT_FLATTEN_MAX=0 in
        the environment (alpha-tested shadow rays through the pka_* table
        split either way);
      * a glass and a metal sphere;
      * emissive lamp meshes on the walls (per-triangle area lights);
      * a distant sun + uniform sky.

    faithful=False is the untextured terrain-only scene: the displaced
    grid, four wall quads, diffuse materials, sun and sky."""
    b = Recorder()
    if faithful:
        base_tid, norm_tid, wall_tid, leaf_tid = _sm_textures(b)
        plaster = b.add_diffuse((0.62, 0.55, 0.45), roughness=0.8,
                                base_tex=base_tid, norm_tex=norm_tid)
        wall_m = b.add_diffuse((0.55, 0.42, 0.32), roughness=0.9,
                               base_tex=wall_tid)
    else:
        plaster = b.add_diffuse((0.62, 0.55, 0.45), roughness=0.8)
        wall_m = b.add_diffuse((0.55, 0.42, 0.32), roughness=0.9)

    side = max(2, int(math.isqrt(n_tris // 2)) + 1)
    xs = np.linspace(0.0, 100.0, side, dtype=np.float32)
    zs = np.linspace(0.0, 100.0, side, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = _sm_height(x, z)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(side - 1), np.arange(side - 1),
                       indexing="ij")
    a = (i * side + j).ravel()
    f = np.concatenate([np.stack([a, a + 1, a + side], -1),
                        np.stack([a + 1, a + side + 1, a + side], -1)],
                       0).astype(np.int32)
    uvs = (np.stack([x, z], -1).reshape(-1, 2) * (8.0 / 100.0)
           ).astype(np.float32) if faithful else None
    b.add_mesh(v, f, uvs=uvs, material=plaster)
    # enclosing walls (quads) keep bounce paths alive (courtyard effect)
    h = 30.0
    b.add_quad([0, -5, 0], [100, 0, 0], [0, h, 0], material=wall_m)
    b.add_quad([0, -5, 100], [100, 0, 0], [0, h, 0], material=wall_m)
    b.add_quad([0, -5, 0], [0, 0, 100], [0, h, 0], material=wall_m)
    b.add_quad([100, -5, 0], [0, 0, 100], [0, h, 0], material=wall_m)

    if faithful:
        # ---- instanced alpha-masked foliage (thousands of instances)
        rng = np.random.default_rng(7)
        leaf_mat = b.add_diffuse((1.0, 1.0, 1.0), roughness=0.9,
                                 base_tex=leaf_tid, alpha_mode=2,
                                 alpha_cutoff=0.5)
        mv, mf, muv = _sm_foliage_model(np.random.default_rng(3))
        shrub = b.add_model(mv, mf, uvs=muv, material=leaf_mat)
        px = rng.uniform(3.0, 97.0, foliage)
        pz = rng.uniform(3.0, 97.0, foliage)
        py = _sm_height(px, pz) - 0.1
        scale = rng.uniform(0.8, 2.2, foliage)
        rot = rng.uniform(0.0, np.pi, foliage)
        for k in range(int(foliage)):
            c, s = math.cos(rot[k]), math.sin(rot[k])
            sc = scale[k]
            t = np.asarray([[c * sc, 0, s * sc, px[k]],
                            [0, sc, 0, py[k]],
                            [-s * sc, 0, c * sc, pz[k]],
                            [0, 0, 0, 1]], np.float32)
            # runtime="auto": the builder re-emits this 240K-triangle
            # foliage as world triangles at build time unless
            # PT_FLATTEN_MAX says otherwise
            b.add_model_instance(shrub, t, runtime="auto")

        # ---- glass / metal props in view
        glass = b.add_dielectric(ior=1.5, roughness=0.0)
        metal = b.add_conductor((0.9, 0.75, 0.4))
        gx, gz = 34.0, 36.0
        b.add_sphere([gx, float(_sm_height(np.float32(gx),
                                           np.float32(gz))) + 3.0, gz],
                     3.0, material=glass)
        mx, mz = 48.0, 30.0
        b.add_sphere([mx, float(_sm_height(np.float32(mx),
                                           np.float32(mz))) + 2.5, mz],
                     2.5, material=metal)

        # ---- emissive lamp meshes on the walls (per-tri area lights)
        lamp_v = np.asarray([[0, 0, 0], [1.6, 0, 0], [1.6, 0.8, 0],
                             [0, 0.8, 0]], np.float32)
        lamp_f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        for k in range(10):
            lx = 8.0 + 9.0 * k
            b.add_mesh(lamp_v + np.asarray([lx, 9.0, 0.35], np.float32),
                       lamp_f, material=wall_m, emission=(24.0, 19.0, 12.0))
            b.add_mesh(lamp_v + np.asarray([lx, 9.0, 99.65], np.float32),
                       lamp_f, material=wall_m, emission=(24.0, 19.0, 12.0))

    b.add_distant_light(direction=(-0.35, -1.0, -0.25),
                        color=(6.0, 5.7, 5.2))              # sun
    b.add_uniform_inf_light((0.35, 0.45, 0.65))             # sky
    b.set_camera(look_from=[6.0, 26.0, 6.0], look_at=[60.0, 2.0, 60.0],
                 fov=math.radians(65.0), resolution=resolution)
    return b.build(accel=accel)
