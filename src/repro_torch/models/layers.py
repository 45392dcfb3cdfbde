"""Layers of every LM family: norms, RoPE, GQA and cross attention, GLU
MLP, capacity-based MoE and Mamba2 (SSD).

Counterpart of ``repro.models.layers``. The plain
functions take the reference's layouts ((B, S, H, hd) activations) and
dtypes; the modules hold the parameters under the reference's names and
in its (in, out) layout, so ``x @ w`` reads the same as there and the
converter copies arrays one for one. Prefill attention goes through
:func:`repro_torch.kernels.ops.flash_attention` (the hand-written kernel
on CUDA, its plain version on the CPU), which has no backward; training
attention is :func:`blocked_attention`, the reference's jnp blocked
softmax as torch ops under autograd; one-step decode attention is
plain torch, as the reference has no kernel there. The MoE dispatch and
the SSD are plain torch too, as they are XLA in the reference. The
reference's sharding constraints (``wsc``) are left out: the port's
``parallel.api.wsc`` changes only a DTensor, and these functions take
plain tensors. What a mesh changes here it changes through
``parallel.api``: ``moe_ffn_local`` dispatches per data shard, and where
the batch is spread over several processes both MoE functions run
their collectives (``parallel.api.processes``); ``moe_ffn_ep`` runs one
rank's experts of the sharded step (``parallel.spmd``) with the model
group's and the batch groups' collectives it is given.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.parallel import api

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


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_offset: int = 0, kv_len=None,
                      block: int = 1024) -> torch.Tensor:
    """The reference's ``gqa_attention``: GQA with an online softmax over
    kv blocks, as plain torch ops that autograd differentiates (training
    runs this; prefill takes the flash kernel). q (B, Sq, Hq, hd), k and v
    (B, Skv, Hkv, hd); ``q_offset`` is q[0]'s absolute position, ``kv_len``
    the number of valid kv positions (an int or a 0-dim tensor). The
    block halves until it divides Skv. Rounds where the reference does:
    ``q * scale`` in q's dtype, P in v's dtype before P.V, both products
    accumulated in f32, o, m and l carried in f32, l floored at 1e-30."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qg = (q * _scale_in(hd, q.dtype)).reshape(B, Sq, Hkv, rep, hd).float()
    blk = min(block, Skv)
    while Skv % blk:
        blk //= 2
    qpos = q_offset + torch.arange(Sq, device=q.device)
    valid = Skv if kv_len is None else kv_len
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Sq, Hkv, rep, hd), **f32)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, **f32)
    l = torch.zeros((B, Hkv, rep, Sq), **f32)
    for start in range(0, Skv, blk):
        kb = k[:, start:start + blk].to(q.dtype).float()
        vb = v[:, start:start + blk]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb)
        kpos = start + torch.arange(blk, device=q.device)
        mask = kpos[None, :] < valid
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(),
                          vb.float())
        o = o * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    o = o / torch.clamp(l.permute(0, 3, 1, 2), min=1e-30)[..., None]
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


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

    def blocked(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """Full-sequence training attention through
        :func:`blocked_attention` (kv blocks of ``cfg.attn_block``)."""
        q, k, v = self.qkv(x, positions)
        o = blocked_attention(q, k, v, causal=self.cfg.causal,
                              block=self.cfg.attn_block)
        B, S, _ = x.shape
        return o.reshape(B, S, -1) @ self.wo

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


def cross_attention(p: Attention, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor], cfg,
                    blocked: bool = False) -> torch.Tensor:
    """Encoder-decoder cross attention: q from ``x`` (B, S, D) without
    RoPE, non-causal over the encoder's k and v (B, S_enc, Hkv, hd);
    through the flash kernel, or with ``blocked`` (training) through
    :func:`blocked_attention` in kv blocks of ``cfg.attn_block``."""
    B, S, _ = x.shape
    q = (x @ p.wq).view(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p.bq.view(cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    if blocked:
        o = blocked_attention(q, k, v, causal=False, block=cfg.attn_block)
    else:
        o = gqa_attention(q, k, v, causal=False)
    return o.reshape(B, S, -1) @ p.wo


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


# ---------------------------------------------------------------------------
# Mixture of Experts (token-dropping, capacity-based)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """Top-k MoE FFN, the reference's ``init_moe`` tree: ``router`` (D, E)
    in float32, ``w1``, ``w3`` (E, D, F) and ``w2`` (E, F, D), and with
    ``n_shared_experts`` a ``shared`` MLP of width F * n_shared."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, Fe, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = new_param(D, E, dtype=torch.float32, device=device)
        self.w1 = new_param(E, D, Fe, device=device)
        self.w3 = new_param(E, D, Fe, device=device)
        self.w2 = new_param(E, Fe, D, device=device)
        if cfg.n_shared_experts:
            self.shared = MLP(D, Fe * cfg.n_shared_experts, cfg.act, device)


class Route(NamedTuple):
    """Where a call's T*K (token, expert) entries go, in the order of a
    stable sort by expert: expert ``se``, token ``st``, gate ``sg`` and
    place ``pos`` in the expert's buffer; ``keep`` is ``pos < C``, and
    ``slot`` the entry's row of the flat (E*C, D) buffer, or E*C when it
    is dropped. ``probs`` (T, E) and ``eidx`` (T, K, best first) are the
    router's; ``counts`` (E,) the entries each expert was chosen for;
    ``spos`` (T, K) each token's sorted entries in ascending order, which
    is ascending expert order."""
    probs: torch.Tensor
    eidx: torch.Tensor
    se: torch.Tensor
    st: torch.Tensor
    sg: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    spos: torch.Tensor


def moe_capacity(cfg, T: int) -> int:
    """Slots per expert for a call of T tokens (truncated, at least 8)."""
    return max(8, int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def moe_route(p: MoE, xf: torch.Tensor, cfg, C: int, router=None
              ) -> Route:
    """Router in float32 on xf (T, D) (``router``, by default
    ``p.router``), the top-k experts of each token, then
    :func:`moe_assign`."""
    probs = torch.softmax(xf.float() @ (p.router if router is None
                                         else router), dim=-1)
    return moe_assign(probs, torch.topk(probs, cfg.top_k)[1], C)


def moe_assign(probs: torch.Tensor, eidx: torch.Tensor, C: int) -> Route:
    """Gates of the chosen experts ``eidx`` (T, K), normalised by
    ``max(sum, 1e-9)``, then the reference's stable argsort of the flat
    expert ids and each entry's place in its expert's buffer."""
    (T, E), K = probs.shape, eidx.shape[1]
    dev = probs.device
    gate = probs.gather(1, eidx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    fe = eidx.reshape(T * K)
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - starts[se]
    counts = torch.diff(starts, append=starts.new_full((1,), T * K))
    keep = pos < C
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    return Route(probs, eidx, se, order // K, gate.reshape(T * K)[order],
                 pos, keep, torch.where(keep, se * C + pos, E * C), counts,
                 inv.view(T, K).sort(dim=1).values)


def _sum_by_token(rows: torch.Tensor, spos: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Each token's K rows of ``rows`` (T*K, D), in sorted entry order,
    read through ``spos`` (T, K) and summed in ascending expert order
    from 0 in ``rows``' dtype, then rounded to ``dtype``."""
    y = torch.zeros((spos.shape[0], rows.shape[1]), dtype=rows.dtype,
                    device=rows.device)
    for k in range(spos.shape[1]):
        y = y + rows[spos[:, k]]
    return y.to(dtype)


class _Dispatch(torch.autograd.Function):
    """:func:`moe_dispatch` with a backward that sums in a fixed order.
    Autograd's own backward of ``xf[r.st]`` would accumulate each token's
    ``top_k`` gradient rows by an ``index_put_`` whose order on CUDA is
    not fixed; this one gives each token the sum of its entries' rows of
    the buffer's gradient (a dropped entry's is zero) in
    :func:`moe_combine`'s order, as that combine does with unit gates."""

    @staticmethod
    def forward(ctx, xf, slot, st, spos, E: int, C: int):
        ctx.save_for_backward(slot, spos)
        D = xf.shape[1]
        flat = xf.new_zeros((E * C + 1, D))
        flat[slot] = xf[st]
        return flat[:E * C].view(E, C, D)

    @staticmethod
    def backward(ctx, g):
        slot, spos = ctx.saved_tensors
        flat = F.pad(g.reshape(-1, g.shape[-1]), (0, 0, 0, 1))
        return (_sum_by_token(flat[slot].float(), spos, g.dtype),
                None, None, None, None, None)


def moe_dispatch(xf: torch.Tensor, r: Route, E: int, C: int
                 ) -> torch.Tensor:
    """The (E, C, D) capacity buffer: each kept entry's token row at its
    place, zeros elsewhere. Kept places are distinct, so this is a plain
    scatter; dropped entries land on a spare row that is cut off. Its
    gradient sums each token's rows in a fixed order (:class:`_Dispatch`)."""
    return _Dispatch.apply(xf, r.slot, r.st, r.spos, E, C)


def moe_experts(p: MoE, buf: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's GLU on its whole buffer, empty slots included, as
    the reference multiplies them: (E, C, D) -> (E, C, D)."""
    return glu_mlp(buf, p.w1, p.w3, p.w2, act)


def moe_combine(out: torch.Tensor, r: Route) -> torch.Tensor:
    """Gather each kept entry's expert output times its gate (in the
    model's dtype; a dropped entry reads a zero row), then sum each
    token's entries in ascending expert order from 0.0 in float32 and
    round: the order of the reference's scatter-add, the same on every
    device and in every run."""
    flat = out.reshape(-1, out.shape[-1])
    tok = F.pad(flat, (0, 0, 0, 1))[r.slot] * r.sg[:, None].to(out.dtype)
    return _sum_by_token(tok.float(), r.spos, out.dtype)


def moe_ffn(p: MoE, x: torch.Tensor, cfg):
    """Top-k capacity-based MoE: x (B, S, D) -> (y (B, S, D), aux). The
    tokens of the call (T = B * S) are sorted by expert, scattered into a
    per-expert buffer of ``moe_capacity(cfg, T)`` slots (later entries of
    a full expert are dropped), every expert runs on its buffer, and the
    outputs are gathered back by gate. ``aux`` is the Switch-style load
    balancing loss in float32.

    Where the batch is spread over processes, the reference dispatches
    the whole batch at once: every rank gathers all ranks' rows (in rank
    order), dispatches them all with the whole batch's capacity, and
    keeps its own rows of y; aux is the whole batch's on every rank."""
    if api.processes() == 1:
        return _moe_ffn(p, x, cfg)
    rank, _ = api.process_group()
    y, aux = _moe_ffn(p, api.all_gather_rows(x), cfg)
    B = x.shape[0]
    return y[rank * B:(rank + 1) * B], aux


def _moe_ffn(p: MoE, x: torch.Tensor, cfg):
    B, S, D = x.shape
    E, T = cfg.n_experts, B * S
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, D)
    r = moe_route(p, xf, cfg, C)
    y = moe_combine(moe_experts(p, moe_dispatch(xf, r, E, C), cfg.act), r)
    if cfg.n_shared_experts:
        y = y + p.shared(xf)
    ce = r.counts.float() / (T * cfg.top_k)
    aux = E * torch.sum(r.probs.mean(0) * ce)
    return y.reshape(B, S, D), aux


def _dp_shards() -> int:
    """The data shards (pod x data of the context mesh) that this process
    holds: all of them in one process, 1 each when every rank holds
    one; 1 without a mesh."""
    mesh = api.get_mesh()
    return 1 if mesh is None else api.local_shards(mesh)


def moe_ffn_local(p: MoE, x: torch.Tensor, cfg):
    """The reference's hierarchical dispatch: the tokens of each data
    shard are sorted and scattered into that shard's own capacity of
    ``C = max(8, int(Tl * K * cf / E))`` slots an expert (Tl tokens a
    shard, cf 1.0 under ``opt_moe_cf1``), every expert runs on all
    shards' buffers, and each token sums its kept gated outputs from 0
    in the model's dtype (bf16), in ascending expert order, the order of
    the reference's scatter-add over the sorted entries. ``aux`` counts
    every token of the whole batch, over all processes that hold its
    shards. ``moe_ffn`` when the mesh has one batch shard or none, or the
    tokens do not split evenly over the shards."""
    mesh = api.get_mesh()
    B, S, D = x.shape
    E, K, T = cfg.n_experts, cfg.top_k, B * S
    dp = _dp_shards()
    if mesh is None or mesh.batch_shards <= 1 or T % dp:
        return moe_ffn(p, x, cfg)
    Tl = T // dp
    cf = 1.0 if cfg.opt_moe_cf1 else cfg.capacity_factor
    C = max(8, int(Tl * K * cf / E))
    xf = x.reshape(T, D)
    routes = [moe_route(p, xf[g * Tl:(g + 1) * Tl], cfg, C)
              for g in range(dp)]
    # one (E, dp * C, D) buffer: expert e's slots of shard g at
    # [g * C, (g + 1) * C); a dropped entry goes to the spare row E*dp*C
    slot = torch.cat([torch.where(r.keep, r.se * (dp * C) + g * C + r.pos,
                                  E * dp * C)
                      for g, r in enumerate(routes)])
    st = torch.cat([r.st + g * Tl for g, r in enumerate(routes)])
    spos = torch.cat([r.spos + g * Tl * K for g, r in enumerate(routes)])
    sg = torch.cat([r.sg for r in routes])
    out = moe_experts(p, _Dispatch.apply(xf, slot, st, spos, E, dp * C),
                      cfg.act)
    flat = F.pad(out.reshape(E * dp * C, D), (0, 0, 0, 1))
    y = _sum_by_token(flat[slot] * sg[:, None].to(x.dtype), spos, x.dtype)
    if cfg.n_shared_experts:
        y = y + p.shared(xf)
    prob_sum = torch.stack([r.probs.sum(0) for r in routes]).sum(0)
    counts = torch.stack([r.counts for r in routes]).sum(0).float()
    if api.processes() > 1:
        # summed over the ranks; the backward sums every rank's cotangent
        from torch.distributed.nn.functional import all_reduce
        prob_sum, counts = all_reduce(prob_sum), all_reduce(counts)
        T = T * api.processes()
    aux = E * torch.sum(prob_sum / T * (counts / (T * K)))
    return y.reshape(B, S, D), aux


def moe_ffn_ep(p: MoE, x: torch.Tensor, cfg, first_expert: int = 0,
               model_group=None, batch_groups=(), router=None):
    """Expert parallelism over the "model" axis (``parallel.spmd``). x (B,
    S, D) is this rank's data shard, which every rank of ``model_group``
    holds alike; ``p`` holds this rank's ``p.w1.shape[0]`` experts from
    ``first_expert`` (and its columns of the shared experts). Every rank
    routes the shard over all experts (the router is replicated) with
    the shard's own capacity, ``moe_ffn_local``'s ``C = max(8, int(T * K
    * cf / E))``; it dispatches only the entries routed to its own
    experts (the others read as dropped, through ``_Dispatch``), runs
    them, and sums their gated outputs by token in float32 in ascending
    expert order. The ranks' partial sums are all-reduced over
    ``model_group`` (the partial combine: every rank already holds the
    tokens, so nothing needs an all-to-all), rounded to x's dtype, and
    the shared experts' row-parallel output is added. The gates and the
    dispatched rows enter through ``column_input``, so their gradients
    sum the ranks' parts; the load-balancing ``aux`` sums the router's
    probabilities and the counts over ``batch_groups`` (the ranks that
    hold the other data shards). ``router`` is the whole router weight
    when ``p`` holds a shard of it. With no groups and all experts this
    is ``moe_ffn`` bit for bit."""
    B, S, D = x.shape
    E, K, T = cfg.n_experts, cfg.top_k, B * S
    El = p.w1.shape[0]
    cf = 1.0 if cfg.opt_moe_cf1 else cfg.capacity_factor
    C = max(8, int(T * K * cf / E))
    xf = x.reshape(T, D)
    r = moe_route(p, xf, cfg, C, router)
    xin = api.column_input(xf, model_group)
    mine = r.keep & (r.se >= first_expert) & (r.se < first_expert + El)
    slot = torch.where(mine, (r.se - first_expert) * C + r.pos, El * C)
    out = moe_experts(p, _Dispatch.apply(xin, slot, r.st, r.spos, El, C),
                      cfg.act)
    sg = api.column_input(r.sg, model_group)
    tok = F.pad(out.reshape(El * C, D), (0, 0, 0, 1))[slot] * \
        sg[:, None].to(out.dtype)
    y = api.row_output(_sum_by_token(tok.float(), r.spos, torch.float32),
                       model_group).to(x.dtype)
    if cfg.n_shared_experts:
        s = p.shared
        y = y + api.row_output(glu_mlp(xin, s.w1, s.w3, s.w2, cfg.act),
                               model_group)
    if not batch_groups:
        aux = E * torch.sum(r.probs.mean(0) * (r.counts.float() / (T * K)))
        return y.reshape(B, S, D), aux
    sums = torch.stack([r.probs.sum(0), r.counts.float()])
    for g in batch_groups:
        sums = api.summed(sums, g)
        T = T * torch.distributed.get_world_size(g)
    aux = E * torch.sum(sums[0] / T * (sums[1] / (T * K)))
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD): chunked prefill form and the one-step recurrent form
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    """Mamba2 mixer, the reference's ``init_mamba`` tree: ``in_proj`` (D,
    2*d_in + 2*G*N + H), a depthwise causal conv ``conv_w`` (C, K) and
    ``conv_b`` (C,) over C = d_in + 2*G*N channels, float32 ``dt_bias``,
    ``A_log`` and ``D`` (H,), the gated norm's ``norm_w`` and
    ``out_proj`` (d_in, D)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        GN = cfg.ssm_groups * cfg.ssm_state
        conv_dim = d_in + 2 * GN
        f32 = torch.float32
        self.in_proj = new_param(D, 2 * d_in + 2 * GN + H, device=device)
        self.conv_w = new_param(conv_dim, cfg.ssm_conv, device=device)
        self.conv_b = new_param(conv_dim, device=device)
        self.dt_bias = new_param(H, dtype=f32, device=device)
        self.A_log = new_param(H, dtype=f32, device=device)
        self.D = new_param(H, dtype=f32, device=device)
        self.norm_w = new_param(d_in, device=device)
        self.out_proj = new_param(d_in, D, device=device)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv in float32, u (B, S, C), w (C, K), summed in
    the reference's order: the current tap, then taps 1..K-1 back."""
    K, S = w.shape[1], u.shape[1]
    u, w = u.float(), w.float()
    acc = u * w[:, K - 1]
    for i in range(1, K):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        acc = acc + shifted * w[:, K - 1 - i]
    return acc + b.float()


def _mamba_proj(p: Mamba, x: torch.Tensor, cfg):
    """x @ in_proj split into z (d_in), xBC (d_in + 2*G*N) and raw dt (H)."""
    GN = cfg.ssm_groups * cfg.ssm_state
    return torch.split(x @ p.in_proj,
                       [cfg.d_inner, cfg.d_inner + 2 * GN, cfg.ssm_heads],
                       dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(exp(x) + 1)`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``); ``F.softplus`` returns x itself above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _intra_decay(ddec: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """``exp(ddec)`` on and below the diagonal (``tri``), 0 above. Above
    it ``ddec = cs_i - cs_j`` is positive and passes 88 within a chunk of
    128 at the init's dt and A, so ``exp`` would overflow to inf there:
    the forward drops those entries either way, but the backward would
    multiply ``where``'s zero cotangent by inf and give NaN. Masking to
    -inf first gives 0 there and the same bits below (the reference
    computes ``exp(ddec)`` unmasked, ROADMAP caveat R9)."""
    return torch.exp(ddec.masked_fill(~tri, -math.inf))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD in float32. xh (B, L, H, P), dt (B, L, H), A (H,)
    negative, Bm and Cm (B, L, G, N) -> y (B, L, H, P) and the final state
    (B, H, P, N). A ragged L is zero-padded to whole chunks (dt = 0 leaves
    the state as it is). The reference runs an associative scan over the
    chunks; here it is a loop over them from the first, the same
    recurrence in another order of float32 products."""
    b, l_orig, h, pd = xh.shape
    dt, A = dt.float(), A.float()
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-l_orig) % chunk
    if pad:
        def zp(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        xh, dt, Bm, Cm = zp(xh), zp(dt), zp(Bm), zp(Cm)
    nc = (l_orig + pad) // chunk

    xc = xh.reshape(b, nc, chunk, h, pd).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = Bm.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, 3)
    Ch = Cm.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, 3)
    dA_cs = torch.cumsum(dtc * A, dim=2)                     # (b, c, q, h)

    # intra-chunk: M[i, j] = C_i . B_j * exp(cs_i - cs_j) * dt_j, i >= j
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    cs = dA_cs.permute(0, 1, 3, 2)                           # (b, c, h, q)
    ddec = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    M = torch.where(tri, scores * _intra_decay(ddec, tri), 0.0)
    M = M * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xc)

    # chunk-end states, then the recurrence over chunks
    dec_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs) * dtc
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", dec_end, Bh, xc)
    decay = torch.exp(dA_cs[:, :, -1, :])[..., None, None]  # (b, c, h, 1, 1)
    state = torch.zeros_like(S[:, 0])
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * decay[:, c] + S[:, c]
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Ch, torch.exp(dA_cs),
                           torch.stack(prevs, 1))
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, pd)[:, :l_orig]
    return y, state


def ssd_step(state, xh, dt, A, Bh, Ch):
    """One step of the SSM recurrence in float32: state (B, H, P, N), xh
    (B, H, P), dt (B, H), Bh and Ch (B, H, N) -> (y (B, H, P), state)."""
    state = state * torch.exp(dt * A)[:, :, None, None] + \
        (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    return torch.einsum("bhpn,bhn->bhp", state, Ch), state


def ssd_sequential(xh, dt, A, Bm, Cm):
    """Step-by-step oracle of :func:`ssd_chunked` (same signature, no
    chunk)."""
    b, l, h, pd = xh.shape
    dt, A = dt.float(), A.float()
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    state = torch.zeros((b, h, pd, n), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(l):
        y, state = ssd_step(state, xh[:, t].float(), dt[:, t], A,
                            Bm[:, t].float().repeat_interleave(rep, 1),
                            Cm[:, t].float().repeat_interleave(rep, 1))
        ys.append(y)
    return torch.stack(ys, 1), state


def _gated_out(p: Mamba, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, in the model's dtype."""
    return rmsnorm(y * F.silu(z), p.norm_w) @ p.out_proj


def mamba_block(p: Mamba, x: torch.Tensor, cfg, return_cache: bool = False):
    """Prefill form, x (B, S, D) -> (B, S, D); with ``return_cache`` also
    {"conv": the last K-1 raw conv inputs (B, K-1, C), "ssm": the final
    state (B, H, P, N) float32}."""
    B, S, _ = x.shape
    d_in, GN, H = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    z, xbc_raw, dt_raw = _mamba_proj(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p.conv_w, p.conv_b))
    xs, Bm, Cm = torch.split(xbc, [d_in, GN, GN], dim=-1)
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    dt = softplus(dt_raw.float() + p.dt_bias)
    y, s_final = ssd_chunked(
        xh, dt, -torch.exp(p.A_log),
        Bm.reshape(B, S, cfg.ssm_groups, cfg.ssm_state),
        Cm.reshape(B, S, cfg.ssm_groups, cfg.ssm_state),
        min(cfg.ssm_chunk, S))
    y = y + xh.float() * p.D[:, None]
    out = _gated_out(p, y.reshape(B, S, d_in).to(x.dtype), z)
    if return_cache:
        return out, {"conv": xbc_raw[:, S - (cfg.ssm_conv - 1):, :],
                     "ssm": s_final}
    return out


def mamba_decode(p: Mamba, x: torch.Tensor, cfg, conv: torch.Tensor,
                 ssm: torch.Tensor) -> torch.Tensor:
    """One-step decode, x (B, 1, D). Advances the caches ``conv`` (B,
    K-1, C) and ``ssm`` (B, H, P, N) **in place**, as the attention decode
    writes its cache, and returns (B, 1, D). The conv window is summed in
    float32, as the prefill's conv."""
    B = x.shape[0]
    d_in, GN, H = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    z, xbc, dt_raw = _mamba_proj(p, x, cfg)
    window = torch.cat([conv, xbc], dim=1)                  # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,ck->bc", window.float(),
                                   p.conv_w.float()) + p.conv_b.float())
    conv.copy_(window[:, 1:])
    xs, Bm, Cm = torch.split(conv_out, [d_in, GN, GN], dim=-1)
    xh = xs.reshape(B, H, cfg.ssm_head_dim)
    rep = H // cfg.ssm_groups
    dt = softplus(dt_raw[:, 0].float() + p.dt_bias)
    y, state = ssd_step(
        ssm, xh, dt, -torch.exp(p.A_log),
        Bm.reshape(B, cfg.ssm_groups, cfg.ssm_state).repeat_interleave(rep, 1),
        Cm.reshape(B, cfg.ssm_groups, cfg.ssm_state).repeat_interleave(rep, 1))
    ssm.copy_(state)
    y = y + xh * p.D[:, None]
    return _gated_out(p, y.reshape(B, 1, d_in).to(x.dtype), z)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

# leaves the reference initialises to zeros (norm gains, biases)
_ZERO_INIT = frozenset(("ln1", "ln2", "ln_x", "ln_f", "enc_ln_f", "bq", "bk",
                        "bv", "conv_b", "norm_w"))


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``model`` in place with the reference's
    distributions, drawn from one ``torch.Generator`` seeded with ``seed``
    on the model's device in parameter order: ``N(0, 1/fan_in)`` matrices
    (fan_in = the input width, the second-to-last dim), ``N(0, 0.02^2)``
    embeddings and ``N(0, 0.25)`` conv taps, drawn in float32 and stored in
    the parameter's dtype (bf16, the router float32); zero norms, biases,
    ``conv_b`` and ``norm_w``; Mamba's ``dt_bias = log(expm1(linspace(1e-3,
    0.1, H)) + 1e-9)``, ``A_log = log(linspace(1, 16, H))`` and ``D = 1``.
    The draws differ from ``jax.random``'s for the same seed."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ZERO_INIT:
            p.zero_()
        elif leaf == "dt_bias":
            lin = torch.linspace(1e-3, 0.1, p.shape[0], dtype=f32, device=dev)
            p.copy_(torch.log(torch.exp(lin) - 1.0 + 1e-9))
        elif leaf == "A_log":
            p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[0],
                                             dtype=f32, device=dev)))
        elif leaf == "D":
            p.fill_(1.0)
        else:
            scale = {"emb": 0.02, "conv_w": 0.5}.get(
                leaf, 1.0 / math.sqrt(p.shape[-2]) if p.dim() >= 2 else 1.0)
            p.copy_(torch.randn(p.shape, generator=g, device=dev, dtype=f32)
                    * scale)
    return model
