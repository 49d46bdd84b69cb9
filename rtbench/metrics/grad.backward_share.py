"""Share of the window's differentiable work items (inverse-rendering
steps, forward and backward) spent in `loss.backward()`
(integrators/regen_diff.py's replaying backward pass), in %: the traced
run's window, with a synced mark before and after each backward (the
recording drain's own host syncs come just before it), over the window's
time.  No span syncs the forward."""


def read(ctx):
    b, win = ctx.get("backward_s"), ctx.get("elapsed")
    if not b or not win:
        return None
    return 100.0 * b / win
