"""Share of a forward work item in which the device runs no operation,
in %: 1 - busy / wall, both of the window's first item.  busy is the
union of the device operations' intervals while that item's work runs
again, the same tiles and samples, under torch.profiler (device activity)
after the window; wall is the item's own time in the window, without the
profiler, whose per-launch records slow this host-bound loop by about
1.6x and would inflate the idle share (the result line's busy_s and
window_s are the profiled run's own)."""


def read(ctx):
    tr, wall = ctx["trace"], ctx.get("plain_item_s")
    if tr is None or not len(tr.dev) or not wall:
        return None
    return 100.0 * (1.0 - tr.busy_s() / wall)
