"""Multi-GPU rendering over torch.distributed: one rank per GPU, pixels
sharded over the `dp` axis and sample waves over `sp`."""
