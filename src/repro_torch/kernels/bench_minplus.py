"""Time the (min,+) kernel built from two sources, in turns.

    python3 -m repro_torch.kernels.bench_minplus OTHER.cu

Builds this checkout's ``csrc/minplus.cu`` and ``OTHER.cu`` (a source
with the same ``minplus_f32`` entry point, for example an earlier
commit's, unpacked with ``git archive`` into a git-ignored directory)
and times both on one card on the main path's hop matrices: TONS_SYM 256
(256^3), PT 8x8x8 (512^3) and PT 16^3 (4096^3), in the order other,
this, this, other. This source runs both its paths, f32 and hop; the
other source its f32 path. Both launch through ``minplus.run``, without
the wrappers' checks, so the kernels alone are compared. Each time is
given twice: CUDA events over back-to-back calls (host dispatch
included) and the kernel's own device time from a profiler trace.
Prints the card's name and power limit, then one JSON line per (source,
path, n). Needs a CUDA device and the repository's
``benchmarks/results/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch import convert
from repro_torch.core import topology as PT
from repro_torch.kernels import minplus as mp, ops
from repro_torch.kernels.timing import cuda_ms, device_ms

ROOT = Path(__file__).resolve().parents[3]


def hop_matrices():
    """The main path's hop matrices on the card, int16, by n."""
    tons = convert.load_fabric(
        ROOT / "benchmarks" / "results" / "tons_256.pkl", (4, 8, 8),
        name="TONS_SYM 256")
    return {t.n: ops.hop_matrix(t.edges(), t.n, "cuda")
            for t in (tons, PT.pt((8, 8, 8)), PT.pt((16, 16, 16)))}


def time_library(lib, source: Path, label: str, mats) -> None:
    paths = ("f32", "hops") if label == "this" else ("f32",)
    for n, h in mats.items():
        f = ops.decode_hops(h)
        reps = 5 if n >= 4096 else 100
        for path in paths:
            if path == "f32":
                fn = lambda: mp.run(f, f, lib)                 # noqa: E731
            else:
                fn = lambda: mp.run(h, h, lib, "minplus_hops")  # noqa: E731
            print(json.dumps(dict(
                source=label, path=str(source), kernel=path, n=n,
                ms=cuda_ms(fn, reps),
                **device_ms(fn, reps, "minplus_kernel"), reps=reps)),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_minplus: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    other = args.other.resolve()
    libs = {"this": (mp.library(), mp.SOURCE),
            "other": (mp.load(other, "minplus_other")[0], other)}
    mats = hop_matrices()
    for label in ("other", "this", "this", "other"):
        time_library(*libs[label], label, mats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
