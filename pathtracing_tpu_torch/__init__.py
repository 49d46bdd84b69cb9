"""pathtracing_tpu_torch: the path tracer in PyTorch with CUDA kernels for
NVIDIA Hopper (H100), beside the JAX package pathtracing_tpu.

It imports torch and numpy only (never jax or pathtracing_tpu).  Entry
points run on the GPU unless the caller passes device="cpu"; the CUDA
traversal kernels (csrc/trace2.cu, csrc/trace1.cu) are compiled with nvcc
on first use, not at import.
"""
from .scene.builder import SceneBuilder  # noqa: F401
from .scene.types import SceneMeta  # noqa: F401
from .integrators.path import RenderConfig  # noqa: F401
from .integrators.render import render, render_image  # noqa: F401
from .core.rng import SamplerConfig  # noqa: F401
from .core import filters  # noqa: F401
from . import scenes  # noqa: F401

__version__ = "0.1.0"
