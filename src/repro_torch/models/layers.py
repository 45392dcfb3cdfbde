"""Layers of the dense LM family: norms, RoPE, GQA attention, GLU MLP.

Counterpart of the dense subset of ``repro.models.layers``. The plain
functions take the reference's layouts ((B, S, H, hd) activations) and
dtypes; the modules hold the parameters under the reference's names and
in its (in, out) layout, so ``x @ w`` reads the same as there and the
converter copies arrays one for one. Full-sequence attention goes through
:func:`repro_torch.kernels.ops.flash_attention` (the hand-written kernel
on CUDA, its plain version on the CPU); one-step decode attention is
plain torch, as the reference has no kernel there. The reference's
sharding constraints (``wsc``) are dropped: they do nothing without a
device mesh, and this path runs on one GPU.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in f32 with a ``(1 + weight)`` gain, back in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm (no bias) in f32 with a ``(1 + weight)`` gain."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, weight: torch.Tensor
               ) -> torch.Tensor:
    return rmsnorm(x, weight) if kind == "rmsnorm" else layernorm(x, weight)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding with f32 angles. x: (..., S, H, hd);
    positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.to(torch.float32)[..., None] * inv     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Full-sequence GQA attention in the model's layout: q (B, Sq, Hq,
    hd), k and v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd). The kernel reads
    the transposed views in place; the causal mask is aligned top-left,
    which is the reference's ``gqa_attention`` at ``q_offset=0`` and
    Sq == Skv, the only way prefill calls it."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _scale_in(hd: int, dtype: torch.dtype) -> float:
    """``1/sqrt(hd)`` rounded to ``dtype``: JAX multiplies a bf16 array by
    a Python float in bf16, so the reference's scale is the rounded one."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One-step decode. q: (B, 1, Hq, hd); caches (B, S, Hkv, hd); cache
    positions ``<= pos`` are visible. Rounds where the reference does:
    ``q * scale`` and P in the cache's dtype, both products accumulated
    in f32."""
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = (q * _scale_in(hd, q.dtype)).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float())
    visible = torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bgrk,bkgd->bgrd", p.float(), v_cache.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


def new_param(*shape, dtype=torch.bfloat16, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """Attention sub-layer: ``wq/wk/wv`` (D, H*hd), ``wo`` (Hq*hd, D)
    and, with ``qkv_bias``, ``bq/bk/bv``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.cfg = cfg
        self.wq = new_param(D, Hq * hd, device=device)
        self.wk = new_param(D, Hkv * hd, device=device)
        self.wv = new_param(D, Hkv * hd, device=device)
        self.wo = new_param(Hq * hd, D, device=device)
        if cfg.qkv_bias:
            self.bq = new_param(Hq * hd, device=device)
            self.bk = new_param(Hkv * hd, device=device)
            self.bv = new_param(Hkv * hd, device=device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd), with
        RoPE on q and k."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.view(B, S, cfg.n_heads, cfg.head_dim)
        k = k.view(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.view(B, S, cfg.n_kv_heads, cfg.head_dim)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence (prefill) attention: returns (out, (k, v))."""
        q, k, v = self.qkv(x, positions)
        o = gqa_attention(q, k, v, causal=self.cfg.causal)
        B, S, _ = x.shape
        return o.reshape(B, S, -1) @ self.wo, (k, v)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int, positions: torch.Tensor
               ) -> torch.Tensor:
        """x (B, 1, D); ``positions`` is ``[pos]`` on x's device. Writes
        this step's k, v at ``pos`` of every batch lane of the caches (B,
        S, Hkv, hd) **in place** -- the reference returns updated copies;
        one GPU's cache is too large to copy per layer and step -- then
        attends over positions ``<= pos``."""
        q, k, v = self.qkv(x, positions)
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, pos)
        return o.reshape(x.shape[0], 1, -1) @ self.wo


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def glu_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h, g = x @ w1, x @ w3
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    return (h * g) @ w2


class MLP(nn.Module):
    """Gated MLP: ``w1``, ``w3`` (D, F) and ``w2`` (F, D)."""

    def __init__(self, d_model: int, d_ff: int, act: str, device=None):
        super().__init__()
        self.act = act
        self.w1 = new_param(d_model, d_ff, device=device)
        self.w3 = new_param(d_model, d_ff, device=device)
        self.w2 = new_param(d_ff, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu_mlp(x, self.w1, self.w3, self.w2, self.act)
