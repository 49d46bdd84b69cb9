"""Alpha restart-chain iterations per shadow-predicate call: the stats
"chain_restarts" over "occluded_calls" (scene/intersect.py `_occluded`;
counted only on scenes with alpha materials).  Each restart is an alpha
dispatch and a host sync."""


def read(ctx):
    calls = ctx["stats"].get("occluded_calls")
    if not calls:
        return None
    return ctx["stats"].get("chain_restarts", 0) / calls
