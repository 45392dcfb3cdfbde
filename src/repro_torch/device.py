"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device raises when no GPU is present:
    nothing falls back to the CPU silently -- callers that want the plain
    torch path pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but no CUDA device is "
            "available; pass device='cpu' to run the plain torch path")
    return dev
