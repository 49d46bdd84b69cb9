"""Peak device memory over the window (torch.cuda.max_memory_allocated
after a reset at the window's start), in GiB: the headroom a change that
puts more lanes in a drain spends."""


def read(ctx):
    b = ctx["peak_window_bytes"]
    return b / 2 ** 30 if b else None
