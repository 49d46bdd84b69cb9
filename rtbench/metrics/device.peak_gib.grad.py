"""Peak device memory over the window (torch.cuda.max_memory_allocated
after a reset at the window's start) of the differentiable cell, in GiB:
the recording forward's records and the backward's replay."""


def read(ctx):
    b = ctx["peak_window_bytes"]
    return b / 2 ** 30 if b else None
