"""Public wrappers of the port's kernels, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain torch version in :mod:`ref`; any
other device raises. There is no capability gate and no fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import csr_spmv as _spmv, \
    flash_attention as _fa, minplus as _mp, ref

BIG = 1e9             # "no path yet" in the f32 hop matrix
UNREACHABLE = 1e8     # distances at or above this are unreachable
HOP_INF = ref.HOP_INF  # "no path" in the int16 hop matrix
# the int16 hop path holds n <= HOP_N_MAX nodes: every sum of two hop
# counts, at most 2 * (n - 1), stays below HOP_INF
HOP_N_MAX = HOP_INF // 2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, hd), k and v (B, Hkv, Skv, hd), with
    the causal mask aligned top-left (``qpos >= kpos``). Forward only: it
    raises under autograd when q, k or v requires grad, on every device,
    since the CUDA kernel's output has no ``grad_fn`` and would silently
    drop attention's gradient (training attention is
    ``models.layers.blocked_attention``). Through the custom op
    ``repro_torch::flash_attention``: the kernel on CUDA, the plain
    version on the CPU, an empty output on fake tensors."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad()"
            " or inference_mode(); training attention is "
            "repro_torch.models.layers.blocked_attention")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention has no path for device "
                         f"{q.device}")
    return _fa.OP(q, k, v, causal)


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor,
             vals: torch.Tensor, x: torch.Tensor,
             plan: Optional[_spmv.Plan] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum_e vals[e] * x[indices[e]] over CSR row r in float64
    (bit-identical on both paths): each row of up to ``SEGMENT`` entries
    left to right from 0.0, a longer one in ordered segments of
    ``SEGMENT`` (``ref.csr_spmv_ref``). ``plan`` (``csr_spmv.plan``) is
    the kernel's row classes; the CPU path ignores it. Writes into
    ``out`` when given."""
    if x.device.type == "cuda":
        return _spmv.csr_spmv(indptr, indices, vals, x, plan, out)
    if x.device.type == "cpu":
        got = ref.csr_spmv_ref(indptr, indices, vals, x)
        return got if out is None else out.copy_(got)
    raise ValueError(f"csr_spmv has no path for device {x.device}")


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min_k a[i, k] + b[k, j] in float32."""
    if a.device.type == "cuda":
        return _mp.minplus(a, b)
    if a.device.type == "cpu":
        return ref.minplus_ref(a, b)
    raise ValueError(f"minplus has no path for device {a.device}")


def minplus_hops(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min(HOP_INF, min_k a[i, k] + b[k, j]) on int16 hop
    counts in [0, HOP_INF]."""
    if a.device.type == "cuda":
        return _mp.minplus_hops(a, b)
    if a.device.type == "cpu":
        return ref.minplus_hops_ref(a, b)
    raise ValueError(f"minplus_hops has no path for device {a.device}")


def encode_hops(d: torch.Tensor) -> torch.Tensor:
    """An f32 matrix of hop counts (BIG for no path) as the int16 hop path
    holds it: the inverse of :func:`decode_hops`. It does not check that
    every value is a hop count; :func:`minplus_hops` refuses one out of
    range."""
    return torch.where(d == BIG, HOP_INF, d).to(torch.int16)


def decode_hops(h: torch.Tensor) -> torch.Tensor:
    """The int16 hop matrix back as callers see it: f32 hop counts, BIG
    for no path."""
    return torch.where(h == HOP_INF, BIG, h.float())


def _square_to_fixpoint(d: torch.Tensor, square, n: int):
    """Square ``d`` until a squaring changes nothing (one host sync
    each), at most the reference's ceil(log2(n - 1)) times; returns the
    matrix and the squarings run. Once d (x) d == d every later squaring
    returns d, so the result is the reference's bit for bit."""
    cap = int(math.ceil(math.log2(max(n - 1, 1))))
    runs = 0
    while runs < cap:
        nxt = square(d, d)
        runs += 1
        if torch.equal(nxt, d):
            break
        d = nxt
    return d, runs


def apsp(d: torch.Tensor, stats: Optional[dict] = None) -> torch.Tensor:
    """All-pairs hop distances of the hop matrix ``d`` as an f32 matrix
    with BIG where there is no path: the reference's ``ceil(log2(n - 1))``
    (min,+) squarings, stopped at the first that changes nothing. An
    int16 matrix (:func:`hop_matrix`, HOP_INF for no path) is squared on
    the hop path, an f32 one (BIG for no path) on the f32 path. ``stats``
    gets ``squarings`` (run) and ``path`` ("hops" or "f32")."""
    n = d.shape[0]
    if d.dtype != torch.int16:
        out, runs = _square_to_fixpoint(d, minplus, n)
        path = "f32"
    elif n > HOP_N_MAX:
        raise ValueError(f"the int16 hop path holds at most {HOP_N_MAX} "
                         f"nodes, got {n}")
    else:
        out, runs = _square_to_fixpoint(d, minplus_hops, n)
        out, path = decode_hops(out), "hops"
    if stats is not None:
        stats.update(squarings=runs, path=path)
    return out


def hop_matrix(edges: np.ndarray, n: int, device=None) -> torch.Tensor:
    """Adjacency -> initial (min,+) distance matrix on ``device``, built
    there: 0 on the diagonal, 1 on an edge, "no path" elsewhere. int16
    with HOP_INF for no path up to HOP_N_MAX nodes (the hop path); f32
    with BIG beyond."""
    dev = resolve_device(device)
    dtype, none = ((torch.int16, HOP_INF) if n <= HOP_N_MAX
                   else (torch.float32, BIG))
    d = torch.full((n, n), none, dtype=dtype, device=dev)
    d.fill_diagonal_(0)
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                        device=dev)
    d[e[:, 0], e[:, 1]] = 1
    d[e[:, 1], e[:, 0]] = 1
    return d


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
