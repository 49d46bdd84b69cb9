"""A frozen copy of pathtracing_tpu_torch's plain-PyTorch modules.

Copied from the port (core/, scene/builder.py, scene/intersect.py's
interaction assembly, scene/lights.py, scene/textures.py, sensor/,
integrators/path.py) and cut to what the reference replays: the scene
tables built from the raw description with accel="brute", the camera,
the bounce's shade math (`_make_bounce(replay=...)`) and the film splat.
The traversal code, the kernels and the native libraries are left out;
the reference traverses with its own scan (rtbench/reference/scan.py).
A later change to the port does not change this copy.
"""
