"""Encoder-decoder backbone (seamless-m4t style, audio frontend stubbed).

Counterpart of ``repro.models.seq2seq``. The encoder takes precomputed
frame embeddings (B, S_enc, D) and runs non-causal self-attention with
RoPE; the decoder is a causal LM with cross attention into the encoder's
states (no RoPE there). Prefill's attentions go through the flash
kernel; the training forward's through ``layers.blocked_attention``
under autograd, each layer under ``torch.utils.checkpoint`` with
``cfg.remat``, as the reference's ``scan_blocks(remat=cfg.remat)``. The
cache is ``"k"`` and ``"v"`` (L_dec, B, S, Hkv, hd), the
decoder's self-attention, and ``"ek"`` and ``"ev"`` (L_dec, B, S_enc, Hkv,
hd), each layer's cross-attention keys and values of the encoder states.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.lm import Cache, cross_entropy, pad_seq


class EncBlock(nn.Module):
    """Encoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.new_param(D, device=device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.new_param(D, device=device)
        self.mlp = L.MLP(D, cfg.d_ff, cfg.act, device)


class DecBlock(nn.Module):
    """Decoder layer: ``ln1``, ``attn``, ``ln_x``, ``xattn``, ``ln2``,
    ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D = cfg.d_model
        self.ln1 = L.new_param(D, device=device)
        self.attn = L.Attention(cfg, device)
        self.ln_x = L.new_param(D, device=device)
        self.xattn = L.Attention(cfg, device)
        self.ln2 = L.new_param(D, device=device)
        self.mlp = L.MLP(D, cfg.d_ff, cfg.act, device)


class EncDecLM(nn.Module):
    """Parameters of an encoder-decoder, uninitialised (see
    :func:`init_params` and ``convert.params_from_jax``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.enc_layers))
        self.enc_ln_f = L.new_param(D, device=device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.dec_layers))
        self.emb = L.new_param(V, D, device=device)
        self.ln_f = L.new_param(D, device=device)
        self.lm_head = L.new_param(D, V, device=device)


def init_params(cfg, seed: int = 0, device=None) -> EncDecLM:
    """Random weights on ``device`` (``None`` = CUDA) with the reference's
    distributions (:func:`layers.init_weights_`)."""
    return L.init_weights_(EncDecLM(cfg, resolve_device(device)), seed)


def _layer(fn, cfg, blocked: bool, *args):
    """``fn(cfg, *args, blocked)``; in training (``blocked``) with
    ``cfg.remat`` under ``torch.utils.checkpoint``, recomputed in the
    backward."""
    if blocked and cfg.remat:
        return checkpoint(fn, cfg, *args, blocked, use_reentrant=False)
    return fn(cfg, *args, blocked)


def _enc_layer(cfg, blk: EncBlock, x: torch.Tensor, positions: torch.Tensor,
               blocked: bool) -> torch.Tensor:
    """One encoder layer: non-causal self-attention with RoPE through the
    flash kernel, or with ``blocked`` through ``blocked_attention``."""
    B, S, _ = x.shape
    q, k, v = blk.attn.qkv(L.apply_norm(cfg.norm, x, blk.ln1), positions)
    if blocked:
        a = L.blocked_attention(q, k, v, causal=False, block=cfg.attn_block)
    else:
        a = L.gqa_attention(q, k, v, causal=False)
    x = x + a.reshape(B, S, -1) @ blk.attn.wo
    return x + blk.mlp(L.apply_norm(cfg.norm, x, blk.ln2))


def encode(model: EncDecLM, frames: torch.Tensor, blocked: bool = False
           ) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D) bf16; with
    ``blocked``, the training form (module docstring)."""
    cfg = model.cfg
    x = frames.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)
    for blk in model.enc_blocks:
        x = _layer(_enc_layer, cfg, blocked, blk, x, positions)
    return L.apply_norm(cfg.norm, x, model.enc_ln_f)


def _enc_kv(blk: DecBlock, enc_x: torch.Tensor, cfg):
    """The cross attention's k and v (B, S_enc, Hkv, hd) of the encoder
    states, without RoPE."""
    B, S, _ = enc_x.shape
    k = (enc_x @ blk.xattn.wk).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_x @ blk.xattn.wv).view(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qkv_bias:
        k = k + blk.xattn.bk.view(cfg.n_kv_heads, cfg.head_dim)
        v = v + blk.xattn.bv.view(cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _dec_layer(cfg, blk: DecBlock, x: torch.Tensor, enc_x: torch.Tensor,
               positions: torch.Tensor, blocked: bool = False):
    """One decoder layer over the full sequence: (x, {"k", "v", "ek",
    "ev"} of this layer), both attentions through the flash kernel; with
    ``blocked`` through ``blocked_attention``, and no cache (None)."""
    h = L.apply_norm(cfg.norm, x, blk.ln1)
    if blocked:
        a, kv = blk.attn.blocked(h, positions), None
    else:
        a, kv = blk.attn(h, positions)
    x = x + a
    ek, ev = _enc_kv(blk, enc_x, cfg)
    x = x + L.cross_attention(blk.xattn, L.apply_norm(cfg.norm, x, blk.ln_x),
                              (ek, ev), cfg, blocked)
    x = x + blk.mlp(L.apply_norm(cfg.norm, x, blk.ln2))
    if blocked:
        return x, None
    return x, {"k": kv[0], "v": kv[1], "ek": ek, "ev": ev}


def forward(model: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor
            ) -> torch.Tensor:
    """The training forward: teacher-forced decoder logits (B, S, V),
    every attention through ``blocked_attention``, each layer of both
    stacks under ``torch.utils.checkpoint`` with ``cfg.remat``."""
    cfg = model.cfg
    enc_x = encode(model, frames, blocked=True)
    x = F.embedding(tokens, model.emb).to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in model.dec_blocks:
        # each layer reads the encoder's states through a view of its own:
        # their gradient is summed a layer at a time, in the order the
        # sharded step's FSDP units (which take them as an input) sum it
        x, _ = _layer(_dec_layer, cfg, True, blk, x, enc_x.view_as(enc_x),
                      positions)
    return L.apply_norm(cfg.norm, x, model.ln_f) @ model.lm_head


def loss_fn(model: EncDecLM, batch) -> torch.Tensor:
    """Cross entropy of ``forward(batch["frames"], batch["tokens"])``
    against ``batch["labels"]``. The reference's ``aux_weight`` is unused
    there: an encoder-decoder has no aux loss."""
    logits = forward(model, batch["frames"], batch["tokens"])
    return cross_entropy(logits, batch["labels"])


def prefill(model: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor,
            cache_len: Optional[int] = None):
    """Encode ``frames``, run the prompt ``tokens`` (B, S): (last-token
    logits (B, 1, V), the cache). k and v are padded to ``cache_len``; ek
    and ev keep the encoder's length, as the reference's do."""
    cfg = model.cfg
    enc_x = encode(model, frames)
    x = F.embedding(tokens, model.emb).to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    per: Dict[str, List[torch.Tensor]] = {}
    for blk in model.dec_blocks:
        x, c = _dec_layer(cfg, blk, x, enc_x, positions)
        for name, t in c.items():
            per.setdefault(name, []).append(t)
    caches = {name: torch.stack(ts) for name, ts in per.items()}
    for name in ("k", "v"):
        caches[name] = pad_seq(caches[name], cache_len or tokens.shape[1])
    x = L.apply_norm(cfg.norm, x[:, -1:, :], model.ln_f)
    return x @ model.lm_head, caches


def empty_cache(cfg, B: int, S_dec: int, S_enc: int, device=None) -> Cache:
    """Zero cache: k, v of S_dec positions and ek, ev of S_enc, bf16."""
    dev = resolve_device(device)
    hkv, hd, Ld = cfg.n_kv_heads, cfg.head_dim, cfg.dec_layers

    def zeros(S):
        return torch.zeros((Ld, B, S, hkv, hd), dtype=torch.bfloat16,
                           device=dev)
    return {"k": zeros(S_dec), "v": zeros(S_dec), "ek": zeros(S_enc),
            "ev": zeros(S_enc)}


def decode_step(model: EncDecLM, caches: Cache, token: torch.Tensor,
                pos: int):
    """token (B, 1) at position ``pos`` -> (logits (B, 1, V), caches). The
    self-attention cache is written in place; cross attention attends over
    all S_enc positions of ek and ev (the reference's ``pos = S_enc - 1``),
    its q without bias or RoPE, as the reference's decode has it."""
    cfg = model.cfg
    x = F.embedding(token, model.emb).to(torch.bfloat16)
    B = x.shape[0]
    positions = torch.tensor([pos], device=token.device)
    S_enc = caches["ek"].shape[2]
    for i, blk in enumerate(model.dec_blocks):
        x = x + blk.attn.decode(L.apply_norm(cfg.norm, x, blk.ln1),
                                caches["k"][i], caches["v"][i], pos,
                                positions)
        h = L.apply_norm(cfg.norm, x, blk.ln_x)
        q = (h @ blk.xattn.wq).view(B, 1, cfg.n_heads, cfg.head_dim)
        o = L.decode_attention(q, caches["ek"][i], caches["ev"][i],
                               S_enc - 1)
        x = x + o.reshape(B, 1, -1) @ blk.xattn.wo
        x = x + blk.mlp(L.apply_norm(cfg.norm, x, blk.ln2))
    return L.apply_norm(cfg.norm, x, model.ln_f) @ model.lm_head, caches
