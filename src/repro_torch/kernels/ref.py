"""Plain torch versions of the hand-written kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the oracles the kernels are held to."""
from __future__ import annotations

import math

import torch

# elements of the (M, kc, N) broadcast one chunk of minplus_ref may hold
_CHUNK_ELEMS = 1 << 27


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min, +) matrix product: out[i, j] = min_k a[i, k] + b[k, j].

    The same f32 adds and exact mins as ``repro.kernels.ref.minplus_ref``,
    taken over chunks of ``k`` so that a 4096^2 product never
    materialises the whole ``M * K * N`` broadcast.
    """
    M, K = a.shape
    N = b.shape[1]
    kc = max(1, min(K, _CHUNK_ELEMS // max(M * N, 1)))
    out = None
    for k0 in range(0, K, kc):
        s = (a[:, k0:k0 + kc, None] + b[None, k0:k0 + kc, :]).amin(dim=1)
        out = s if out is None else torch.minimum(out, s)
    return out


def apsp_ref(adj: torch.Tensor, max_iters: int | None = None
             ) -> torch.Tensor:
    """All-pairs shortest paths by repeated (min,+) squaring of the hop
    matrix (diagonal 0, edge 1, else a large value)."""
    n = adj.shape[0]
    d = adj
    iters = max_iters or int(math.ceil(math.log2(max(n - 1, 1))))
    for _ in range(iters):
        d = minplus_ref(d, d)
    return d
