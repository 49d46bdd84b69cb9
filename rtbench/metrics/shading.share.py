"""Share of the span pass's wall time (the window's first item run again
after the window) in shading: integrators/path.py's
`make_interaction`, `resolve_material` (textures), `bsdf_sample` and
`bsdf_eval_pdf` (synced spans from rtbench/spans.py), in %."""


def read(ctx):
    sp, win = ctx["spans"], ctx["span_window_s"]
    if sp is None or not win or not sp.bound["shading"] \
            or not sp.calls["shading"]:
        return None
    return 100.0 * sp.seconds["shading"] / win
