"""PyTorch/CUDA port of ``repro``: the same module layout, run on an
NVIDIA GPU (Hopper) by default. Entry points take ``device=None``
(= CUDA) and raise without a GPU; pass ``device="cpu"`` explicitly for
the plain torch path."""
