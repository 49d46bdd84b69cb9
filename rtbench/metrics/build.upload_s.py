"""Seconds of the set-up's scene build spent in the copy of the scene's
arrays to the device (the host-to-device upload in SceneBuilder.build,
synchronised): the program's always-on counter "build.upload_s" of the
last build (pathtracing_tpu_torch/utils/profile.py::counters). Part of
setup_s. None where the program keeps no such counter."""


def read(ctx):
    from pathtracing_tpu_torch.utils import profile
    counters = getattr(profile, "counters", None)
    if counters is None:
        return None
    return counters().get("build.upload_s")
