"""Sampler kernel launches per work item: render_tile_regen's stats
"rng_launches", the program's count of launches of csrc/sampler.cu
(core/rng.py: hash_u32, hash_float, sample_1d and sample_2d on the card,
one launch each; counted by pathtracing_tpu_torch/utils/profile.py as
"rng.launches").  None where the program keeps no such count."""


def read(ctx):
    n = ctx["stats"].get("rng_launches")
    return n / ctx["items"] if n is not None and ctx["items"] else None
