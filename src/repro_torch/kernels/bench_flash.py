"""Time the flash-attention kernel built from two sources, in turns.

    python3 -m repro_torch.kernels.bench_flash OTHER.cu

Builds this checkout's ``csrc/flash_attention.cu`` and ``OTHER.cu`` (the
same C entry point, for example the source of an earlier commit unpacked
with ``git archive`` into a git-ignored directory) and times both on one
card at the serving head shapes, (1,16,2,S,S,128) bf16 causal read from
the model's (B, S, H, hd) layout at S = 2048, 4096, 8192 and 32768, in
the order other, this, this, other, with PyTorch's SDPA beside each as
the yardstick. Prints the card's name and power limit, then one JSON
line per (source, S). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.timing import cuda_ms

SIZES = (2048, 4096, 8192, 32768)


def time_library(lib, source: Path, label: str) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    for S in SIZES:
        q, k, v = (torch.randn((1, S, H, 128), generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for H in (16, 2, 2))
        reps = 20 if S <= 8192 else 5
        ms = cuda_ms(lambda: fa.run(q, k, v, True, lib), reps)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps)
        print(json.dumps(dict(source=label, path=str(source), S=S, ms=ms,
                              sdpa_ms=sdpa, vs_sdpa=ms / sdpa, reps=reps)),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    other = args.other.resolve()
    libs = {"this": (fa.library(), fa.SOURCE),
            "other": (fa.load(other, "flash_attention_other")[0], other)}
    for label in ("other", "this", "this", "other"):
        time_library(*libs[label], label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
