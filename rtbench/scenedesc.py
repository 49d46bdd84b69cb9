"""A scene as a plain description: the builder calls a scene script makes.

A generator under rtbench/scenes/ writes its scene into a `Recorder`,
which keeps each call (method name, arguments) and returns the id a
SceneBuilder would return.  `replay` makes the same calls on any object
with the SceneBuilder interface: the port's builder for the program, the
reference's frozen copy for the check.  Both see the same arrays.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

# builder methods that return a new id of their own kind
_COUNTED = {"add_diffuse": "mat", "add_dielectric": "mat",
            "add_thin_dielectric": "mat", "add_conductor": "mat",
            "textures.add_image": "tex", "add_model": "model",
            "add_sphere": "sph", "add_quad": "quad"}


class _Sub:
    def __init__(self, rec, prefix):
        self._rec, self._prefix = rec, prefix

    def __getattr__(self, name):
        return self._rec._method(f"{self._prefix}.{name}")


class Recorder:
    """Records SceneBuilder calls; ids follow the builder's numbering."""

    def __init__(self):
        self.calls = []
        self.build_kwargs = {}
        self._ids = {}
        self.textures = _Sub(self, "textures")

    def _method(self, name):
        def call(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            kind = _COUNTED.get(name)
            if kind is None:
                return None
            self._ids[kind] = self._ids.get(kind, -1) + 1
            return self._ids[kind]
        return call

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._method(name)

    def build(self, **kwargs):
        self.build_kwargs = kwargs
        return self


def replay(desc: Recorder, builder):
    """Make desc's calls on `builder`; returns the builder.  Each id the
    builder returns is checked against the recorded one."""
    expected = {}
    for name, args, kwargs in desc.calls:
        target = builder
        for part in name.split(".")[:-1]:
            target = getattr(target, part)
        got = getattr(target, name.split(".")[-1])(*args, **kwargs)
        kind = _COUNTED.get(name)
        if kind is not None:
            expected[kind] = expected.get(kind, -1) + 1
            if got != expected[kind]:
                raise RuntimeError(f"{name} returned id {got}, the "
                                   f"description holds {expected[kind]}")
    return builder


def load_generator(root: Path, name: str):
    """rtbench/scenes/<name>.py's `describe(**params) -> Recorder`."""
    path = Path(root) / "rtbench" / "scenes" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rtbench_scene_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.describe
