"""Share of the span pass's wall time inside the dispatch sort key
(scene/intersect.py `_first_block_key`, a synced span from
rtbench/spans.py), in %.  The span pass is the window's first item run
again, the same work, after the window."""


def read(ctx):
    sp, win = ctx["spans"], ctx["span_window_s"]
    if sp is None or not win or not sp.bound["sort_key"] \
            or not sp.calls["sort_key"]:
        return None
    return 100.0 * sp.seconds["sort_key"] / win
