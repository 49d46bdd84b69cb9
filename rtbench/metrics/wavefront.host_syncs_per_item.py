"""Host syncs per work item: render_tile_regen's stats "host_syncs", the
program's count of the places its hot path waits for the device
(counted by pathtracing_tpu_torch/utils/profile.py): blocking reads of
device values (the drain's alive test, the shadow predicate's restart
test and compaction, the read of the item's device-side counts) and
copies of host data to the device, each of which torch follows with a
stream synchronize (the sampler's integer constants, texture and
interaction constants, the splat's filter offsets).  None where the
program keeps no such count."""


def read(ctx):
    n = ctx["stats"].get("host_syncs")
    return n / ctx["items"] if n and ctx["items"] else None
