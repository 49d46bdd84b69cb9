"""Render checkpoint / resume (counterpart of
pathtracing_tpu/utils/checkpoint.py).

The film accumulator and the sampler position (samples done, seed)
round-trip through one .npz every few sample waves.  The sampler is a
pure function of (pixel, sample index, dimension, seed), so resuming from
(film, samples done) gives the film of an uninterrupted render bit for
bit (on the same device, with the waves splatted in the same order).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device


def save_checkpoint(path, film, samples_done: int, seed: int, resolution,
                    extra: dict | None = None):
    path = Path(path)
    header = dict(samples_done=int(samples_done), seed=int(seed),
                  resolution=[int(x) for x in resolution], extra=extra or {})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, rgb=film["rgb"].detach().cpu().numpy(),
        weight=film["weight"].detach().cpu().numpy(),
        header=np.frombuffer(json.dumps(header).encode(), np.uint8))


def load_checkpoint(path, device=None):
    """Returns (film on `device`, samples_done, seed, resolution, extra);
    the GPU unless device="cpu"."""
    dev = resolve_device(device)
    z = np.load(Path(path))
    header = json.loads(bytes(z["header"]).decode())
    film = dict(rgb=torch.from_numpy(z["rgb"]).to(dev),
                weight=torch.from_numpy(z["weight"]).to(dev))
    return (film, header["samples_done"], header["seed"],
            tuple(header["resolution"]), header["extra"])


def render_with_checkpoints(scene, cam, meta, cfg, spp: int,
                            checkpoint_path, every: int = 16,
                            progress=None, device=None):
    """Render `spp` samples, writing a checkpoint every `every` waves and
    resuming from the checkpoint when it exists.  Runs on the GPU unless
    device="cpu"."""
    from ..integrators.render import render
    from ..sensor.film import new_film

    dev = resolve_device(device)
    done = 0
    film = None
    path = Path(checkpoint_path)
    if path.exists():
        film, done, seed, res, _ = load_checkpoint(path, device=dev)
        if res != tuple(cam["resolution"]) or seed != cfg.sampler.seed:
            raise ValueError(f"checkpoint {path} is of another render "
                             f"(resolution {res}, seed {seed})")
    if film is None:
        film = new_film(cam["resolution"], device=dev)
    while done < spp:
        step = min(every, spp - done)
        film = render(scene, cam, meta, cfg, film=film, spp=step,
                      sample_offset=done, device=dev)
        done += step
        save_checkpoint(path, film, done, cfg.sampler.seed,
                        cam["resolution"])
        if progress:
            progress(done, spp)
    return film
