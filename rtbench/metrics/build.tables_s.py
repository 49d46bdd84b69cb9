"""Seconds of the set-up's scene build spent in build_traversal_tables: the
traversal tables of the scene's triangles, the alpha micro-mask build
included: the program's always-on counter "build.tables_s" of the last
build (pathtracing_tpu_torch/utils/profile.py::counters). Part of
setup_s. None where the program keeps no such counter."""


def read(ctx):
    from pathtracing_tpu_torch.utils import profile
    counters = getattr(profile, "counters", None)
    if counters is None:
        return None
    return counters().get("build.tables_s")
