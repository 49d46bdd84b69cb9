"""The San-Miguel-class courtyard with its shrubs kept as run-time
instances.

The frozen sanmiguel_analog description (rtbench/scenes/sanmiguel_analog.py)
with each `add_model_instance` call's runtime="auto" made runtime=True:
the program and the reference both keep the shrubs as instances of one
model under their own transforms (a top level over one bottom level),
whatever PT_FLATTEN_MAX says, where runtime="auto" flattens them into
world triangles.  Every other call is the same.
"""
from __future__ import annotations

from pathlib import Path

from rtbench.scenedesc import load_generator

ROOT = Path(__file__).resolve().parents[2]


def describe(**params):
    desc = load_generator(ROOT, "sanmiguel_analog")(**params)
    desc.calls = [(name, args, dict(kwargs, runtime=True)
                   if name == "add_model_instance"
                   and kwargs.get("runtime") == "auto" else kwargs)
                  for name, args, kwargs in desc.calls]
    return desc
