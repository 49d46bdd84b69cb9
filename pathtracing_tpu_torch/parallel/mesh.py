"""Multi-GPU rendering: the device mesh, the sharded render and the
sharded inverse-rendering step (counterpart of
pathtracing_tpu/parallel/mesh.py).

The mesh spans the torch.distributed process group, one rank per GPU,
laid out dp x sp (rank r sits at dp index r // sp, sp index r % sp):

  * the scene is replicated: every rank builds or loads the same scene;
  * pixels are sharded over `dp`: each rank traces its block of the
    padded pixel range and splats into its own full-resolution film;
  * sample waves are sharded over `sp`: sp index j renders samples
    [j * spp / sp, (j + 1) * spp / sp);
  * the films are summed with one all_reduce, so every rank holds the
    frame; for inverse rendering the partial films are summed inside the
    loss and the gradients all-reduced.
Samples and pixels are assigned as the reference package assigns them to
its devices, so the film equals render()'s up to summation order.  Without
a process group the mesh is one rank (dp = sp = 1).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.device import resolve_device, to_device
from ..integrators.path import RenderConfig
from ..integrators.render import regen_schedule, render_tile, \
    render_tile_regen
from ..sensor import film as filmmod


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp x sp ranks of the process group; `rank` is this process's."""
    dp: int
    sp: int
    rank: int

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, sp: int = 1) -> Mesh:
    """The dp x sp mesh over every rank of the process group (dp = ranks /
    sp); n_devices, when given, must be the group's size."""
    world, rank = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the process group has {world} ranks, not "
                         f"{n_devices}")
    if world % sp:
        raise ValueError(f"{world} ranks not divisible by sp={sp}")
    return Mesh(dp=world // sp, sp=sp, rank=rank)


def _pad_pixels(npix: int, parts: int, batch: int):
    """Pixels per dp rank: npix / parts rounded up to a multiple of batch."""
    per = -(-npix // parts)
    per = -(-per // batch) * batch
    return per


def _all_reduce(t):
    """Sum of `t` over the process group (t itself without one)."""
    if _world()[0] > 1:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def _merge(film):
    """Every rank's partial film summed, as one [H*W, 4] all_reduce."""
    acc = _all_reduce(torch.cat([film["rgb"], film["weight"][:, None]], -1))
    return dict(rgb=acc[:, :3].contiguous(), weight=acc[:, 3].contiguous())


def render_sharded(scene, cam, meta, cfg: RenderConfig, mesh: Mesh | None
                   = None, spp: int | None = None, sample_offset: int = 0,
                   device=None):
    """Full-frame render sharded over the mesh; every rank returns the
    whole film.  Runs on the GPU (the rank's current one) unless
    device="cpu".  With cfg.regenerate each rank drains its own queues of
    (pixels x local sample waves), grouped by
    regen_schedule(divisor=True)."""
    dev = resolve_device(device)
    scene, cam = to_device(scene, dev), to_device(cam, dev)
    mesh = mesh or make_mesh()
    spp = cfg.spp if spp is None else spp
    w, h = cam["resolution"]
    npix = w * h
    if spp % mesh.sp:
        raise ValueError(f"spp={spp} not divisible by sp={mesh.sp}")
    spp_local = spp // mesh.sp
    batch = min(cfg.rays_per_batch, npix)
    per = _pad_pixels(npix, mesh.dp, min(batch, -(-npix // mesh.dp)))
    batch = min(batch, per)
    n_tiles = per // batch
    pix = torch.arange(mesh.dp_index * per, (mesh.dp_index + 1) * per,
                       dtype=torch.int64, device=dev)
    offset = sample_offset + mesh.sp_index * spp_local
    film = filmmod.new_film((w, h), device=dev)
    if cfg.regenerate and not cfg.differentiable:
        g_tiles, wpg = regen_schedule(n_tiles, spp_local, divisor=True)
        gbatch = g_tiles * batch
        for t in range(n_tiles // g_tiles):
            idx = pix[t * gbatch:(t + 1) * gbatch]
            done = 0
            while done < spp_local:
                waves = min(wpg, spp_local - done)
                film = render_tile_regen(scene, cam, meta, cfg, film, idx,
                                         waves, offset + done, lanes=batch)
                done += waves
    else:
        for s in range(spp_local):
            for t in range(n_tiles):
                film = render_tile(scene, cam, meta, cfg, film,
                                   pix[t * batch:(t + 1) * batch], 1,
                                   offset + s)
    return _merge(film)


def render_image_sharded(scene, cam, meta, cfg: RenderConfig,
                         mesh: Mesh | None = None, spp: int | None = None,
                         device=None):
    film = render_sharded(scene, cam, meta, cfg, mesh, spp, device=device)
    w, h = cam["resolution"]
    return filmmod.finalize(film).reshape(h, w, 3)


# ---------------------------------------------------------------------------
# Sharded inverse-rendering train step
# ---------------------------------------------------------------------------

DEFAULT_PARAM_KEYS = ("mat_base", "mat_rough", "mat_metal", "light_color")


def train_step_sharded(scene, cam, meta, cfg: RenderConfig, target,
                       mesh: Mesh | None = None, lr: float = 0.05,
                       param_keys=DEFAULT_PARAM_KEYS, spp: int | None = None,
                       sample_offset: int = 0, device=None):
    """One SGD step of inverse rendering sharded over the mesh: the MSE of
    the differentiable render against `target` [H,W,3].  The ranks'
    partial films are summed inside the loss (filter spill across shard
    borders is exchanged before the normalisation), so the loss and its
    gradient do not depend on the rank count; each rank's gradient of its
    own contribution is all-reduced into the full gradient.

    Returns (new params dict, loss), the same on every rank; the scene is
    left as it is (merge with {**scene, **new_params})."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, differentiable=True)
    scene, cam = to_device(scene, dev), to_device(cam, dev)
    mesh = mesh or make_mesh()
    spp = cfg.spp if spp is None else spp
    w, h = cam["resolution"]
    npix = w * h
    if spp % mesh.sp:
        raise ValueError(f"spp={spp} not divisible by sp={mesh.sp}")
    spp_local = spp // mesh.sp
    per = _pad_pixels(npix, mesh.dp, 8)
    pix = torch.arange(mesh.dp_index * per, (mesh.dp_index + 1) * per,
                       dtype=torch.int64, device=dev)
    offset = sample_offset + mesh.sp_index * spp_local

    params = {k: scene[k].detach().clone().requires_grad_(True)
              for k in param_keys}
    scene_l = {**scene, **params}
    film = filmmod.new_film((w, h), device=dev)
    for s in range(spp_local):
        film = render_tile(scene_l, cam, meta, cfg, film, pix, 1, offset + s)
    # the merged film, differentiable in this rank's own contribution
    own = torch.cat([film["rgb"], film["weight"][:, None]], -1)
    merged = own + (_all_reduce(own.detach()) - own.detach())
    rgb, weight = merged[:, :3], merged[:, 3]
    img = rgb / torch.clamp(weight, min=1e-12)[:, None]
    target_flat = torch.as_tensor(target, dtype=torch.float32,
                                  device=dev).reshape(npix, 3)
    err = torch.where((weight > 0)[:, None], img - target_flat, 0.0)
    loss = torch.sum(err * err) / (npix * 3)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    new_params = {}
    for (k, p), g in zip(params.items(), grads):
        g = torch.zeros_like(p) if g is None else _all_reduce(g)
        new_params[k] = (p - lr * g).detach()
    return new_params, loss.detach()
