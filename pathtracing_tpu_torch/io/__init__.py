"""Scene import and export: glTF / OBJ models, the scene cache, Radiance
HDR images."""
from .gltf import load_gltf            # noqa: F401
from .obj import load_obj              # noqa: F401
from .cache import save_scene, load_scene  # noqa: F401
from .hdr import read_hdr, write_hdr  # noqa: F401
