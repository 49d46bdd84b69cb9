"""The plain reference that decides a run's `correct`.

It imports nothing of pathtracing_tpu_torch: `snap/` is a frozen copy of
the port's plain-PyTorch shading, sampling, camera, film and scene-table
code, and `scan.py` its own brute-force traversal.
"""
