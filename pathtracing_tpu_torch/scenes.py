"""Built-in example scenes (counterpart of pathtracing_tpu/scenes.py).

Each builder returns (scene, cam, meta) on `device` (the GPU unless
device="cpu").
"""
from __future__ import annotations

import math

import numpy as np

from .scene.builder import SceneBuilder


def cornell_box(resolution=(256, 256), light_emission=(15.0, 15.0, 15.0),
                device=None):
    """Cornell-style analytic box: diffuse walls, one area light, a glass
    and a metal sphere."""
    b = SceneBuilder()
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    red = b.add_diffuse((0.65, 0.05, 0.05), roughness=1.0)
    green = b.add_diffuse((0.12, 0.45, 0.15), roughness=1.0)
    glass = b.add_dielectric(ior=1.5, roughness=0.0)
    metal = b.add_conductor((0.8, 0.85, 0.88))

    s = 555.0
    b.add_quad([s, 0, 0], [0, s, 0], [0, 0, s], material=green)    # left
    b.add_quad([0, 0, 0], [0, s, 0], [0, 0, s], material=red)      # right
    b.add_quad([0, 0, 0], [s, 0, 0], [0, 0, s], material=white)    # floor
    b.add_quad([0, s, 0], [s, 0, 0], [0, 0, s], material=white)    # ceiling
    b.add_quad([0, 0, s], [s, 0, 0], [0, s, 0], material=white)    # back
    b.add_quad([213, s - 1.0, 227], [130, 0, 0], [0, 0, 105],
               material=white, emission=light_emission, one_sided=False)
    b.add_sphere([190, 90, 190], 90, material=glass)
    b.add_sphere([380, 90, 380], 90, material=metal)
    b.set_camera(look_from=[278, 278, -800], look_at=[278, 278, 0],
                 fov=math.radians(40.0) * 2, resolution=resolution)
    return b.build(device=device)


def furnace(resolution=(64, 64), albedo=(0.73, 0.73, 0.73),
            sky=(1.0, 1.0, 1.0), device=None):
    """White-furnace probe: one diffuse sphere in a uniform dome."""
    b = SceneBuilder()
    mat = b.add_diffuse(albedo, roughness=1.0)
    b.add_sphere([0, 0, 0], 1.0, material=mat)
    b.add_uniform_inf_light(sky)
    b.set_camera(look_from=[0, 0, -4], look_at=[0, 0, 0],
                 fov=math.radians(30.0), resolution=resolution)
    return b.build(device=device)


def mat_test(resolution=(440, 720), rows=11, cols=18, spacing=2.2,
             radius=1.0, device=None):
    """Roughness x metallic sphere grid (BSDF regression chart)."""
    b = SceneBuilder()
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    for i in range(rows):
        for j in range(cols):
            rough = i / max(rows - 1, 1)
            metal = j / max(cols - 1, 1)
            m = b.add_diffuse((0.8, 0.2, 0.2), roughness=max(rough, 0.05),
                              metallic=metal)
            b.add_sphere([(j - cols / 2) * spacing,
                          (i - rows / 2) * spacing, 0.0], radius,
                         material=m)
    b.set_camera(look_from=[0, 0, -40], look_at=[0, 0, 0],
                 fov=math.radians(35.0), resolution=resolution)
    return b.build(device=device)


def spheres_medium(resolution=(128, 128), device=None):
    """Homogeneous-medium probe: a glass sphere filled with fog and a
    diffuse sphere on a floor under an area light, in a thin scene-wide
    haze (render with integrator="volpath")."""
    b = SceneBuilder()
    fog = b.add_medium(sigma_a=(0.02, 0.02, 0.02),
                       sigma_s=(0.15, 0.15, 0.15), g=0.0)
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    glass = b.add_dielectric(ior=1.5, roughness=0.0)
    b.add_quad([-50, 0, -50], [100, 0, 0], [0, 0, 100], material=white)
    b.add_sphere([0, 2, 0], 2.0, material=glass, medium=fog)
    b.add_sphere([-5, 1.5, 2], 1.5, material=white)
    b.add_quad([-3, 10, -3], [6, 0, 0], [0, 0, 6], material=white,
               emission=(20, 20, 20))
    b.add_uniform_inf_light((0.05, 0.07, 0.1))
    b.set_scene_medium(
        b.add_medium(sigma_a=(0.001, 0.001, 0.001),
                     sigma_s=(0.01, 0.01, 0.01), g=0.0))
    b.set_camera(look_from=[0, 4, -14], look_at=[0, 2, 0],
                 fov=math.radians(35.0), resolution=resolution)
    return b.build(device=device)


def sphere_mesh(center, radius, n_lat=40, n_lon=64):
    """(vertices [V,3], indices [F,3]) of a latitude-longitude sphere with
    outward-facing winding: 2 * n_lon * (n_lat - 1) triangles."""
    theta = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    phi = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.repeat(np.cos(theta)[:, None], n_lon, 1),
                     np.sin(theta)[:, None] * np.sin(phi)[None]], -1)
    v = np.concatenate([[[0.0, 1.0, 0.0]], ring.reshape(-1, 3),
                        [[0.0, -1.0, 0.0]]])
    top, bot = 0, len(v) - 1
    j = np.arange(n_lon)
    jn = (j + 1) % n_lon
    faces = [np.stack([np.full(n_lon, top), 1 + jn, 1 + j], -1)]
    for i in range(n_lat - 2):
        a, b = 1 + i * n_lon, 1 + (i + 1) * n_lon
        faces += [np.stack([a + j, a + jn, b + j], -1),
                  np.stack([a + jn, b + jn, b + j], -1)]
    last = 1 + (n_lat - 2) * n_lon
    faces.append(np.stack([last + j, last + jn, np.full(n_lon, bot)], -1))
    f = np.concatenate(faces).astype(np.int32)
    vw = (v * radius + np.asarray(center)).astype(np.float32)
    # outward winding: flip the faces whose normal points at the center
    e = np.cross(vw[f[:, 1]] - vw[f[:, 0]], vw[f[:, 2]] - vw[f[:, 0]])
    inward = (e * (vw[f].mean(1) - np.asarray(center))).sum(-1) < 0
    f[inward] = f[inward][:, [0, 2, 1]]
    return vw, f


def medium_mesh(resolution=(48, 48), n_lat=40, n_lon=64, device=None):
    """A medium bounded by a triangle mesh: a 4,992-triangle sphere mesh
    with no material and medium=fog inside it (so its triangles go
    through the traversal kernels) beside a diffuse sphere, on a floor
    under an area light and a sky (render with integrator="volpath")."""
    b = SceneBuilder()
    fog = b.add_medium(sigma_a=(0.05, 0.05, 0.05),
                       sigma_s=(0.4, 0.3, 0.2), g=0.3)
    white = b.add_diffuse((0.73, 0.73, 0.73), roughness=1.0)
    b.add_quad([-20, 0, -20], [40, 0, 0], [0, 0, 40], material=white)
    b.add_mesh(*sphere_mesh((0.0, 2.0, 0.0), 2.0, n_lat, n_lon), medium=fog)
    b.add_sphere([-4, 1, 1], 1.0, material=white)
    b.add_quad([-2, 8, -2], [4, 0, 0], [0, 0, 4], material=white,
               emission=(15, 15, 15))
    b.add_uniform_inf_light((0.1, 0.1, 0.12))
    b.set_camera(look_from=[0, 3, -10], look_at=[0, 2, 0],
                 fov=math.radians(40.0), resolution=resolution)
    return b.build(device=device)


def textured_quad(resolution=(128, 128), device=None):
    """Texture/alpha feature probe: an alpha-MASK checker cutout on an
    analytic quad over a diffuse floor, in a uniform dome."""
    b = SceneBuilder()
    tex = np.zeros((64, 64, 4), np.float32)
    xx, yy = np.meshgrid(np.arange(64), np.arange(64))
    tex[..., 0] = (xx / 63.0)
    tex[..., 1] = (yy / 63.0)
    tex[..., 2] = 0.5
    tex[..., 3] = np.where(((xx // 8) + (yy // 8)) % 2 == 0, 1.0, 0.0)
    tid = b.textures.add_image(tex)
    mat = b.add_diffuse((1, 1, 1), roughness=1.0, base_tex=tid,
                        alpha_mode=2, alpha_cutoff=0.5)
    floor = b.add_diffuse((0.6, 0.6, 0.6), roughness=1.0)
    b.add_quad([-5, 0, -5], [10, 0, 0], [0, 0, 10], material=floor)
    b.add_quad([-2, 1, 0], [4, 0, 0], [0, 3, 0], material=mat)
    b.add_uniform_inf_light((1.0, 1.0, 1.0))
    b.set_camera(look_from=[0, 3, -8], look_at=[0, 2, 0],
                 fov=math.radians(35.0), resolution=resolution)
    return b.build(device=device)


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


def sanmiguel_analog(resolution=(1920, 1080), n_tris=10_500_000,
                     accel="auto", faithful=True, foliage=2500, device=None):
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
    b = SceneBuilder()
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
    return b.build(accel=accel, device=device)


SCENES = dict(cornell=cornell_box, furnace=furnace, mat_test=mat_test,
              medium=spheres_medium, textured=textured_quad,
              sanmiguel_analog=sanmiguel_analog)
