"""Bounce iterations per work item: render_tile_regen's stats
"iterations".  Each iteration costs at least one host sync (the drain's
alive test), so on a host-bound frame the item's time follows it."""


def read(ctx):
    n = ctx["stats"].get("iterations")
    return n / ctx["items"] if n and ctx["items"] else None
