"""Rays traced per camera sample over the window: render_tile_regen's
stats "n_rays" (closest-hit and shadow rays) over every sample of every
item.  Moves fwd_samples_per_s: each ray is a traversal and its shading."""


def read(ctx):
    n = ctx["stats"].get("n_rays")
    return n / ctx["samples"] if n and ctx["samples"] else None
