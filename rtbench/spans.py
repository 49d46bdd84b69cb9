"""Synced spans around calls into the port's layers, from outside.

`Spans.install()` wraps module attributes of the port with a timer that
synchronises the device before and after the call, so a span's seconds
are the layer's own (device work included).  The syncs cost the frame
time, so only the traced run's span items carry them, never the measured
window.  A span binds to the attribute's name: a rename in the port
makes its metric null (PERF.md lists the names).
"""
from __future__ import annotations

import time

import torch

# span name -> [(module, attribute), ...]
SPANS = {
    "sort_key": [("pathtracing_tpu_torch.scene.intersect",
                  "_first_block_key")],
    "shading": [("pathtracing_tpu_torch.integrators.path",
                 "make_interaction"),
                ("pathtracing_tpu_torch.integrators.path",
                 "resolve_material"),
                ("pathtracing_tpu_torch.integrators.path", "bsdf_sample"),
                ("pathtracing_tpu_torch.integrators.path", "bsdf_eval_pdf")],
}


class Spans:
    def __init__(self, spans=SPANS):
        self.spans = spans
        self.seconds = {name: 0.0 for name in spans}
        self.calls = {name: 0 for name in spans}
        self.bound = {name: True for name in spans}
        self._saved = []
        self._depth = 0

    def install(self):
        import importlib
        for name, targets in self.spans.items():
            for modname, attr in targets:
                mod = importlib.import_module(modname)
                if not hasattr(mod, attr):
                    self.bound[name] = False
                    continue
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(name, orig))
        return self

    def remove(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def _wrap(self, name, fn):
        spans = self

        def timed(*args, **kwargs):
            if spans._depth:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spans._depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                spans._depth -= 1
                torch.cuda.synchronize()
                spans.seconds[name] += time.perf_counter() - t0
                spans.calls[name] += 1
        return timed
