"""Dispatch sort key kernel launches per work item: render_tile_regen's
stats "sort_key_launches", the program's count of launches of
csrc/sortkey.cu (scene/intersect.py `_first_block_key` on the card, one
launch a key; counted by pathtracing_tpu_torch/utils/profile.py as
"sort_key.launches").  None where the program keeps no such count."""


def read(ctx):
    n = ctx["stats"].get("sort_key_launches")
    return n / ctx["items"] if n is not None and ctx["items"] else None
