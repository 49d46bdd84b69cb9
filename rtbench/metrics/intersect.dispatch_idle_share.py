"""Share of the device's idle time in the profiled forward work item (the
window's first item run again under torch.profiler after the window)
charged to the traversal dispatch: intersect.dispatch (key, argsort,
pad, the table runs, unsort), intersect.sort_key and the host side of
the K1 / K2 launches (k1.launch, k2.launch), in %.

Idle time is the part of the stretch from the item's first device
operation to its last that no operation covers; each idle gap is placed
on the host's clock to end at the issue of the operation that ends it,
and each idle instant is charged to the innermost program span open then
(pathtracing_tpu_torch/utils/profile.py: the spans record while the
profiler runs; idle_share). The base is the item's idle seconds in all.
None when the run recorded none of these spans."""

NAMES = ('intersect.dispatch', 'intersect.sort_key', 'k1.launch', 'k2.launch')


def read(ctx):
    from pathtracing_tpu_torch.utils import profile
    share = getattr(profile, "idle_share", None)
    tr = ctx["trace"]
    if tr is None or share is None:
        return None
    return share(tr.dev_names, tr.dev, tr.host_names, tr.host,
                 profile.spans(), NAMES)
