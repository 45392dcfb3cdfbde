"""Plain torch versions of the hand-written kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the oracles the kernels are held to."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.csr_spmv import SEGMENT

# elements of the (M, kc, N) broadcast one chunk of minplus_ref may hold
_CHUNK_ELEMS = 1 << 27
NEG_INF = -1e30       # the flash kernels' masked score
HOP_INF = 16383       # the hop path's int16 "no path": INF + INF fits


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Materialised softmax attention with GQA head grouping, in f32.

    q (B, Hq, Sq, hd); k, v (B, Hkv, Skv, hd); head ``h`` reads kv head
    ``h // (Hq / Hkv)``; any strides. Follows the Pallas kernel
    ``repro.kernels.flash_attention._kernel``: scores from ``q * scale``
    and ``k`` in f32, masked scores ``-1e30``, and the causal mask
    ``qpos >= kpos`` with both counted from 0 (top-left). The JAX
    ``ref.flash_attention_ref`` aligns it bottom-right instead; the two
    agree when Sq == Skv (reference caveat R5 in ROADMAP.md). The output
    has q's dtype.
    """
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if causal:
        visible = torch.ones(Sq, Skv, dtype=torch.bool,
                             device=q.device).tril()
        s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)


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


def minplus_hops_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The hop path's (min, +) product on int16 hop counts in
    [0, HOP_INF]: out[i, j] = min(HOP_INF, min_k a[i, k] + b[k, j]).

    The same triples as :func:`minplus_ref`, in the integer type (a sum
    is at most 2 * HOP_INF, which int16 holds), chunked the same way and
    capped at HOP_INF as the kernel's accumulator is.
    """
    M, K = a.shape
    N = b.shape[1]
    kc = max(1, min(K, _CHUNK_ELEMS // max(M * N, 1)))
    out = torch.full((M, N), HOP_INF, dtype=a.dtype, device=a.device)
    for k0 in range(0, K, kc):
        s = (a[:, k0:k0 + kc, None] + b[None, k0:k0 + kc, :]).amin(dim=1)
        out = torch.minimum(out, s)
    return out


def csr_spmv_ref(indptr: torch.Tensor, indices: torch.Tensor,
                 vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_e vals[e] * x[indices[e]] over row r's CSR entries.

    The order of ``csrc/csr_spmv.cu``: a row of at most ``SEGMENT``
    entries is summed left to right from 0.0; a longer row in consecutive
    segments of ``SEGMENT`` entries (the last one shorter), each summed
    left to right from 0.0, then the segment sums left to right from 0.0.
    On the CPU ``index_add_`` adds one at a time in index order into a
    zero vector, so that is two passes: the products into one slot per
    (row, segment), then the slots into their rows. When no row is longer
    than ``SEGMENT`` the slots are the rows, and the second pass, which
    would add each to 0.0, is skipped: a sum from 0.0 is never -0.0, so
    ``0.0 + s == s`` bit for bit.
    """
    rows = indptr.numel() - 1
    lens = indptr.diff()
    prods = vals * x[indices.long()]
    row_of = torch.repeat_interleave(
        torch.arange(rows, device=indptr.device), lens)
    out = torch.zeros(rows, dtype=vals.dtype, device=vals.device)
    if rows == 0 or int(lens.max()) <= SEGMENT:
        return out.index_add_(0, row_of, prods)
    segs = (lens + SEGMENT - 1) // SEGMENT
    first = torch.cumsum(segs, 0) - segs            # each row's first slot
    pos = torch.arange(prods.numel(), device=indptr.device) - indptr[row_of]
    slot_of = first[row_of] + pos // SEGMENT
    slots = torch.zeros(int(segs.sum()), dtype=vals.dtype,
                        device=vals.device).index_add_(0, slot_of, prods)
    row_of_slot = torch.repeat_interleave(
        torch.arange(rows, device=indptr.device), segs)
    return out.index_add_(0, row_of_slot, slots)


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
