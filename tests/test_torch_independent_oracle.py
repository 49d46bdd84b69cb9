"""The port's converged means against the from-scratch NumPy oracle
(tests/independent_oracle.py), with tests/test_independent_oracle.py's
scene and rules: the whole-image mean within 2%, every block of pixels
brighter than 0.05 within 12%.

Every other port test holds the port to the JAX package, so an estimator
fault both packages share would pass them; the oracle shares no code with
either.  The oracle's rays come from the port's own camera (the camera
model is not under test), with fresh uniform jitter.

- `*_full` (slow): the JAX test's exact settings (512 spp, sampler seeds
  17 / 11, oracle generators 303 / 101, oracle spp 512 / 768, 4x4 blocks).
  chip_smoke.py's [oracle] phase runs the same settings on the card, with
  `build_scene`'s floor also as a triangle mesh through both traversal
  kernels.
- Tier-1: the port at reduced spp (`REDUCED`), the oracle's side
  unchanged.  The spp and block sizes were chosen from the worst readings
  over 12 sampler seeds (CHANGES.md); a planted fault must fail the same
  gate by at least twice its tolerance.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from independent_oracle import trace as oracle_trace
from independent_oracle import trace_mis as oracle_trace_mis

from pathtracing_tpu_torch import RenderConfig, SamplerConfig, SceneBuilder
from pathtracing_tpu_torch.core.filters import box
from pathtracing_tpu_torch.integrators.render import render
from pathtracing_tpu_torch.sensor.camera import generate_ray

RES = (32, 32)
MAX_DEPTH = 4
SKY = (0.3, 0.4, 0.55)
FLOOR_BASE = (0.65, 0.6, 0.55)
SPH_BASE = (0.5, 0.3, 0.25)
LIGHT_EM = (14.0, 12.0, 10.0)
FLOOR = ([-8.0, 0, -8], [16.0, 0, 0], [0.0, 0, 16])      # q, u, v

MEAN_TOL = 0.02
BLOCK_TOL = 0.12
LUM_FLOOR = 0.05

# the JAX test's settings, per integrator: the port's spp, sampler grid and
# seed, the oracle's estimator, generator seed and spp
FULL = dict(
    path=dict(spp=512, grid=(32, 16), seed=17, oracle=oracle_trace_mis,
              oracle_seed=303, oracle_spp=512),
    simple=dict(spp=512, grid=(32, 16), seed=11, oracle=oracle_trace,
                oracle_seed=101, oracle_spp=768))
# tier-1: the port's spp, grid (x * y = spp, as the JAX test's 32 x 16 at
# 512) and block side.  Chosen so that the worst block reads under 8% (two
# thirds of the rule) at every one of sampler seeds 0-11: `path` 64 spp on
# 4x4 blocks reads at most 3.5%; `simple` (BSDF sampling only, the small
# light found by chance) at 128 spp reads up to 12.0% on 4x4 blocks and at
# most 5.8% on 8x8 blocks, so its reduced run is held on 8x8 blocks.
REDUCED = dict(path=dict(spp=64, grid=(8, 8), block=4),
               simple=dict(spp=128, grid=(16, 8), block=8))
# the planted fault: the sphere's base colour scaled by 0.7 reads a worst
# 4x4 block off by 30.0% in the reduced `path` run (0.85 reads 16.0%)
FAULT_SCALE = 0.7


def build_scene(device="cpu", floor_cells=0, accel="auto",
                sph_base=SPH_BASE):
    """The JAX test's scene (tests/test_independent_oracle.py:34-44).
    floor_cells=n: the floor as an n x n-cell triangle mesh (2 n^2
    triangles, normals along u x v as the quad's) over the same quad, so
    the oracle's prims do not change; the sphere and the one-sided emitter
    stay analytic."""
    b = SceneBuilder()
    floor = b.add_diffuse(FLOOR_BASE)
    if floor_cells:
        q, u, v = (np.asarray(x, np.float32) for x in FLOOR)
        s = np.arange(floor_cells + 1, dtype=np.float32) / floor_cells
        verts = (q + s[:, None, None] * u + s[None, :, None] * v).reshape(
            -1, 3)
        i, j = np.meshgrid(np.arange(floor_cells), np.arange(floor_cells),
                           indexing="ij")
        v00 = (i * (floor_cells + 1) + j).ravel()
        v10, v01 = v00 + floor_cells + 1, v00 + 1
        idx = np.concatenate([np.stack([v00, v10, v10 + 1], -1),
                              np.stack([v00, v10 + 1, v01], -1)])
        b.add_mesh(verts, idx, material=floor)
    else:
        b.add_quad(*FLOOR, material=floor)
    b.add_sphere([0, 1, 0], 1.0, material=b.add_diffuse(sph_base))
    # n = u x v points DOWN: the one-sided emitter lights the scene below
    b.add_quad([-1, 4, -1], [2, 0, 0], [0, 0, 2], emission=LIGHT_EM,
               one_sided=True)
    b.add_uniform_inf_light(SKY)
    b.set_camera([0, 2.5, -7], [0, 1, 0], math.radians(45), RES)
    return b.build(accel=accel, device=device)


def oracle_prims():
    return [
        dict(kind="quad", q=np.array(FLOOR[0]), u=np.array(FLOOR[1]),
             v=np.array(FLOOR[2]),
             mat=dict(base=FLOOR_BASE, rough=1.0, metal=0.0)),
        dict(kind="sphere", c=np.array([0.0, 1, 0]), r=1.0,
             mat=dict(base=SPH_BASE, rough=1.0, metal=0.0)),
        dict(kind="quad", q=np.array([-1.0, 4, -1]),
             u=np.array([2.0, 0, 0]), v=np.array([0.0, 0, 2]),
             emit=np.array(LIGHT_EM), one_sided=True, mat=None),
    ]


def port_config(integrator, spp, grid, seed):
    return RenderConfig(spp=spp, max_depth=MAX_DEPTH, integrator=integrator,
                        filter=box(),
                        sampler=SamplerConfig(x_samples=grid[0],
                                              y_samples=grid[1], seed=seed))


def port_image(scene, cam, meta, cfg, device="cpu"):
    """The film's weighted mean per pixel as a float64 [H, W, 3] array."""
    film = render(scene, cam, meta, cfg, device=device)
    img = film["rgb"] / torch.clamp(film["weight"], min=1e-12)[:, None]
    return img.cpu().double().numpy().reshape(RES[1], RES[0], 3)


def oracle_image(integrator):
    """The oracle's converged image under FULL[integrator]'s settings, on
    the CPU, its rays from the port's camera."""
    s = FULL[integrator]
    _, cam, _ = build_scene("cpu")
    w_res, h_res = RES
    px, py = np.meshgrid(np.arange(w_res), np.arange(h_res))
    px = px.ravel().astype(np.float32)
    py = py.ravel().astype(np.float32)
    rng = np.random.default_rng(s["oracle_seed"])
    acc = np.zeros((h_res * w_res, 3))
    chunk = 64
    prims = oracle_prims()
    for _ in range(s["oracle_spp"] // chunk):
        jit = rng.random((chunk, h_res * w_res, 2))
        p = np.stack([px[None, :] + jit[..., 0],
                      py[None, :] + jit[..., 1]], -1).reshape(-1, 2)
        p = torch.from_numpy(p.astype(np.float32))
        o, d, _ = generate_ray(cam, p, torch.zeros(p.shape[0]),
                               torch.zeros((p.shape[0], 2)))
        li = s["oracle"](prims, SKY, o.numpy(), d.numpy(), MAX_DEPTH, rng)
        acc += li.reshape(chunk, -1, 3).sum(0)
    return (acc / s["oracle_spp"]).reshape(h_res, w_res, 3)


def errors(ours, oracle, block=4):
    """(relative error of the whole-image mean, worst relative error of
    the block means over the blocks of oracle mean > LUM_FLOOR)."""
    rel = abs(ours.mean() - oracle.mean()) / oracle.mean()
    nb_y, nb_x = RES[1] // block, RES[0] // block
    blocks_o = ours.reshape(nb_y, block, nb_x, block, 3).mean((1, 3, 4))
    blocks_i = oracle.reshape(nb_y, block, nb_x, block, 3).mean((1, 3, 4))
    mask = blocks_i > LUM_FLOOR
    brel = np.abs(blocks_o - blocks_i)[mask] / blocks_i[mask]
    return float(rel), float(brel.max())


def check(ours, oracle, block=4):
    rel, worst = errors(ours, oracle, block)
    print(f"mean off by {rel:.3%}, worst {block}x{block} block off by "
          f"{worst:.3%}")
    assert rel < MEAN_TOL, f"overall mean off by {rel:.1%}"
    assert worst < BLOCK_TOL, (
        f"worst {block}x{block}-block mean off by {worst:.1%}")


@pytest.fixture(scope="module")
def oracles():
    return {}


def _oracle(oracles, integrator):
    if integrator not in oracles:
        oracles[integrator] = oracle_image(integrator)
    return oracles[integrator]


def _reduced(integrator, sph_base=SPH_BASE):
    r = REDUCED[integrator]
    cfg = port_config(integrator, r["spp"], r["grid"],
                      FULL[integrator]["seed"])
    return port_image(*build_scene(sph_base=sph_base), cfg)


@pytest.mark.parametrize("integrator", ["path", "simple"])
def test_torch_matches_independent_oracle(oracles, integrator):
    """The port at REDUCED spp against the oracle at the JAX test's
    settings."""
    ours = _reduced(integrator)
    check(ours, _oracle(oracles, integrator), REDUCED[integrator]["block"])


def test_torch_independent_oracle_gate_catches_a_fault(oracles):
    """The same reduced `path` run with the sphere's base colour scaled by
    FAULT_SCALE: the block rule must fail by at least twice its
    tolerance."""
    ours = _reduced("path", tuple(FAULT_SCALE * c for c in SPH_BASE))
    rel, worst = errors(ours, _oracle(oracles, "path"),
                        REDUCED["path"]["block"])
    print(f"planted fault (sphere base x {FAULT_SCALE}): mean off by "
          f"{rel:.1%}, worst block off by {worst:.1%}")
    assert worst >= 2 * BLOCK_TOL, worst


@pytest.mark.slow
def test_torch_path_matches_independent_oracle_full(oracles):
    s = FULL["path"]
    ours = port_image(*build_scene(),
                      port_config("path", s["spp"], s["grid"], s["seed"]))
    check(ours, _oracle(oracles, "path"))


@pytest.mark.slow
def test_torch_simple_matches_independent_oracle_full(oracles):
    s = FULL["simple"]
    ours = port_image(*build_scene(),
                      port_config("simple", s["spp"], s["grid"], s["seed"]))
    check(ours, _oracle(oracles, "simple"))
