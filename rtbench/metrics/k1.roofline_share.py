"""K1's share of its roofline on the window's own closest-hit rays
(rtbench/roofline.py: the first closest dispatches of the span pass on
the opaque two-level tables, replayed under CUDA events; the bound from
the benchmark's frozen count of a pruned walk on those rays and tables),
in %."""


def read(ctx):
    k1 = ctx.get("k1_roofline")
    return None if not k1 else k1["share"]
