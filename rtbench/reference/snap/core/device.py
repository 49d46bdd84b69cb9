"""Device selection for the public entry points.

Entry points run on the GPU unless the caller asks for the CPU with
`device="cpu"`; without a GPU they raise instead of quietly running on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available")
    return device


def to_device(tree, device: torch.device):
    """Move every tensor of a (flat) dict to `device`; other values pass."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}
