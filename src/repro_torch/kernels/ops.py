"""Public wrappers of the port's kernels, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain torch version in :mod:`ref`; any
other device raises. There is no capability gate and no fallback.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import minplus as _mp, ref

BIG = 1e9             # "no path yet" in the hop matrix
UNREACHABLE = 1e8     # distances at or above this are unreachable


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min_k a[i, k] + b[k, j] in float32."""
    if a.device.type == "cuda":
        return _mp.minplus(a, b)
    if a.device.type == "cpu":
        return ref.minplus_ref(a, b)
    raise ValueError(f"minplus has no path for device {a.device}")


def apsp(d: torch.Tensor) -> torch.Tensor:
    """All-pairs hop distances by ``ceil(log2(n - 1))`` (min,+) squarings
    of the hop matrix ``d``."""
    n = d.shape[0]
    for _ in range(int(math.ceil(math.log2(max(n - 1, 1))))):
        d = minplus(d, d)
    return d


def hop_matrix(edges: np.ndarray, n: int, device=None) -> torch.Tensor:
    """Adjacency -> initial (min,+) distance matrix (0 on the diagonal, 1
    on an edge, BIG elsewhere), float32 on ``device``."""
    d = np.full((n, n), BIG, np.float32)
    np.fill_diagonal(d, 0.0)
    d[edges[:, 0], edges[:, 1]] = 1.0
    d[edges[:, 1], edges[:, 0]] = 1.0
    return torch.from_numpy(d).to(resolve_device(device))


def hop_distances(edges: np.ndarray, n: int, device=None) -> torch.Tensor:
    """(n, n) float32 hop distances on ``device`` (``None`` = CUDA), with
    values >= UNREACHABLE for unreachable pairs."""
    return apsp(hop_matrix(edges, n, device))


def topology_metrics(edges: np.ndarray, n: int, block: int = 128,
                     device=None):
    """Diameter + average hops via the (min,+) APSP path.

    ``block`` is the reference's Pallas tile, kept for the same signature;
    neither path here pads to it (the CUDA kernel handles ragged edges).
    """
    d = hop_distances(edges, n, device)
    far = d >= UNREACHABLE
    diam = int(torch.where(far, -1.0, d).max())
    avg = float(torch.where(far, 0.0, d).double().sum() / (n * (n - 1)))
    return diam, avg
