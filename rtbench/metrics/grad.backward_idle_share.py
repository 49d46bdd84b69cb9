"""Share of the device's idle time in the profiled inverse-rendering step
(the window's first item, forward and backward, run again under
torch.profiler after the window) charged to the replaying backward pass:
the span grad.backward and every span under it (grad.replay,
grad.autograd and the shading spans of the replayed bounces), in %.

Idle time is the part of the stretch from the step's first device
operation to its last that no operation covers; each idle gap is placed
on the host's clock to end at the issue of the operation that ends it,
and each idle instant is charged to the innermost program span open then
on any thread (the backward runs on autograd's device thread;
pathtracing_tpu_torch/utils/profile.py: the spans record while the
profiler runs; idle_share). The base is the step's idle seconds in all.
None when the run recorded no grad.backward span."""


def read(ctx):
    from pathtracing_tpu_torch.utils import profile
    share = getattr(profile, "idle_share", None)
    tr = ctx["trace"]
    if tr is None or share is None:
        return None
    return share(tr.dev_names, tr.dev, tr.host_names, tr.host,
                 profile.spans(), ("grad.backward",), subtree=True)
