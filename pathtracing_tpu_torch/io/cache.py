"""Scene cache (counterpart of pathtracing_tpu/io/cache.py).

The whole built scene (every table, the traversal tables included), the
camera and the SceneMeta round-trip through one .npz, so rendering a big
imported model again skips both the parsing and the SAH build.  The
arrays are stored uncompressed: a 10M-triangle scene is gigabytes, and
zlib would cost more time than the cache saves.

This package's traversal tables differ from the reference package's, so
its caches carry their own format tag: a cache written by the reference
package, or by an older format of this one, raises StaleCacheError (the
CLI then rebuilds) and is never misread.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..scene.types import SceneMeta

_FORMAT = "pathtracing_tpu_torch"
_FORMAT_VERSION = 1


class StaleCacheError(RuntimeError):
    """The cache is of another format or an older version; rebuild it."""


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def save_scene(path, scene, cam, meta: SceneMeta):
    """Write (scene, camera, meta) to one .npz file."""
    path = Path(path)
    blobs = {f"scene/{k}": _np(v) for k, v in scene.items()}
    blobs.update({f"cam/{k}": _np(v) for k, v in cam.items()
                  if k != "resolution"})
    header = dict(format=_FORMAT, version=_FORMAT_VERSION,
                  meta=dataclasses.asdict(meta),
                  resolution=[int(x) for x in cam["resolution"]])
    blobs["header"] = np.frombuffer(json.dumps(header).encode("utf-8"),
                                    np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **blobs)


def load_scene(path, device=None):
    """Read a scene cache onto `device` (the GPU unless device="cpu").
    Returns (scene, cam, meta)."""
    dev = resolve_device(device)
    z = np.load(Path(path), allow_pickle=False)
    header = json.loads(bytes(z["header"]).decode("utf-8"))
    if (header.get("format") != _FORMAT
            or header.get("version") != _FORMAT_VERSION):
        fmt = header.get("format", "the reference package's")
        raise StaleCacheError(
            f"scene cache {path} is {fmt} format v{header.get('version')}, "
            f"this package reads {_FORMAT} v{_FORMAT_VERSION}; rebuild it")

    def part(prefix):
        return {k.split("/", 1)[1]: torch.from_numpy(z[k]).to(dev)
                for k in z.files if k.startswith(prefix)}

    scene, cam = part("scene/"), part("cam/")
    cam["resolution"] = tuple(header["resolution"])
    # json gives lists where SceneMeta holds tuples (it must stay hashable)
    meta = SceneMeta(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in header["meta"].items()})
    return scene, cam, meta
