"""Device time of the traversal kernel K1's instanced instantiations
(csrc/trace2.cu: trace2_kernel / trace2_window_kernel with the template
argument INST true, the second one) in the profiled pass (the window's
first item run again under torch.profiler), in ms per item.  None when
none ran."""
import re

# "trace2_kernel<1, true, false, 8>(...)": AMASK, INST, MOTION, W
INST = re.compile(r"trace2_(?:window_)?kernel<\s*\d+\s*,\s*true\s*,")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ms = [e - s for name, (s, e) in zip(tr.dev_names, tr.dev)
          if INST.search(name)]
    return 1e-3 * sum(ms) if ms else None
