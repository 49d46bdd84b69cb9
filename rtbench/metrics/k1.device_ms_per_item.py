"""Device time of the traversal kernel K1 (csrc/trace2.cu: trace2_kernel,
trace2_window_kernel) in the profiled pass (the window's first item run
again under torch.profiler), in ms per item.  None when K1 did not run."""

K1 = ("trace2_kernel", "trace2_window_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s = tr.seconds_matching(*K1)
    return None if s is None else 1e3 * s
