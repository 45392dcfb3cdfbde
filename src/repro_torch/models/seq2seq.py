"""Encoder-decoder backbone (seamless-m4t style, audio frontend stubbed).

Counterpart of ``repro.models.seq2seq``. The encoder takes precomputed
frame embeddings (B, S_enc, D) and runs non-causal self-attention with
RoPE; the decoder is a causal LM with cross attention into the encoder's
states (no RoPE there). Both prefill attentions go through the flash
kernel. The cache is ``"k"`` and ``"v"`` (L_dec, B, S, Hkv, hd), the
decoder's self-attention, and ``"ek"`` and ``"ev"`` (L_dec, B, S_enc, Hkv,
hd), each layer's cross-attention keys and values of the encoder states.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.lm import Cache, pad_seq


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


def encode(model: EncDecLM, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D) bf16."""
    cfg = model.cfg
    x = frames.to(torch.bfloat16)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    for blk in model.enc_blocks:
        h = L.apply_norm(cfg.norm, x, blk.ln1)
        q, k, v = blk.attn.qkv(h, positions)
        a = L.gqa_attention(q, k, v, causal=False)
        x = x + a.reshape(B, S, -1) @ blk.attn.wo
        x = x + blk.mlp(L.apply_norm(cfg.norm, x, blk.ln2))
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
               positions: torch.Tensor):
    """One decoder layer over the full sequence: (x, {"k", "v", "ek",
    "ev"} of this layer)."""
    a, (k, v) = blk.attn(L.apply_norm(cfg.norm, x, blk.ln1), positions)
    x = x + a
    ek, ev = _enc_kv(blk, enc_x, cfg)
    x = x + L.cross_attention(blk.xattn, L.apply_norm(cfg.norm, x, blk.ln_x),
                              (ek, ev), cfg)
    x = x + blk.mlp(L.apply_norm(cfg.norm, x, blk.ln2))
    return x, {"k": k, "v": v, "ek": ek, "ev": ev}


def forward(model: EncDecLM, frames: torch.Tensor, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, V)."""
    cfg = model.cfg
    enc_x = encode(model, frames)
    x = F.embedding(tokens, model.emb).to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in model.dec_blocks:
        x, _ = _dec_layer(cfg, blk, x, enc_x, positions)
    return L.apply_norm(cfg.norm, x, model.ln_f) @ model.lm_head


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
