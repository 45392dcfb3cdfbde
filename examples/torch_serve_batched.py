"""Batched serving on the PyTorch port: continuous batching over decode
slots, the counterpart of ``serve_batched.py``. Prefill attention runs
the hand-written flash-attention kernel on the GPU.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--arch <id>] [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.launch.serve import main  # noqa: E402,F401

if __name__ == "__main__":
    main()
