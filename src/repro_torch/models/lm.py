"""Decoder-only LM, dense family: init, forward, prefill and decode.

Counterpart of the dense family of ``repro.models.lm``. The layers are an
``nn.ModuleList`` run by a Python loop, not a scanned stack; parameters
keep the reference's names (``blocks.{i}.attn.wq`` is layer ``i`` of the
reference's stacked ``blocks/attn/wq``). The KV cache is a dict of two
(L, B, S, Hkv, hd) bf16 tensors, the reference's stacked layout, and
:func:`decode_step` writes it in place. The other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]

_LATER = {
    "moe": "ROADMAP.md section 1 item 6 (MoE: moe_ffn, first_k_dense)",
    "ssm": "ROADMAP.md section 1 item 7 (Mamba2/SSD)",
    "hybrid": "ROADMAP.md section 1 item 8 (hybrid Mamba+attention+MoE)",
    "encdec": "ROADMAP.md section 1 item 9 (encoder-decoder, seq2seq)",
}
_ZERO_INIT = ("ln1", "ln2", "ln_f", "bq", "bk", "bv")


def check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port runs the dense family only; {cfg.family!r} "
            f"({cfg.name}) is {_LATER.get(cfg.family, 'not planned')}")


class Block(nn.Module):
    """One pre-norm decoder layer: attention and a gated MLP."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.new_param(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.new_param(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        a, kv = self.attn(L.apply_norm(self.cfg.norm, x, self.ln1), positions)
        x = x + a
        x = x + self.mlp(L.apply_norm(self.cfg.norm, x, self.ln2))
        return x, kv

    def decode(self, x, k_cache, v_cache, pos: int, positions):
        x = x + self.attn.decode(L.apply_norm(self.cfg.norm, x, self.ln1),
                                 k_cache, v_cache, pos, positions)
        return x + self.mlp(L.apply_norm(self.cfg.norm, x, self.ln2))


class DecoderLM(nn.Module):
    """Parameters of a dense decoder LM, uninitialised (see
    :func:`init_params` and ``convert.lm_params_from_jax``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_family(cfg)
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.emb = L.new_param(V, D, device=device)
        self.ln_f = L.new_param(D, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = L.new_param(D, V, device=device)
        if cfg.n_vision_tokens:
            self.vis_proj = L.new_param(D, D, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    def head(self) -> torch.Tensor:
        return self.emb.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg, seed: int = 0, device=None) -> DecoderLM:
    """Random weights on ``device`` (``None`` = CUDA) from an explicit
    ``torch.Generator`` seeded with ``seed``, with the reference's
    distributions: ``N(0, 1/fan_in)`` matrices (fan_in = the input
    width), ``N(0, 0.02^2)`` embeddings, all drawn in f32 and stored in
    bf16; zero norms and biases. The draws differ from ``jax.random``'s
    for the same seed (compare on converted weights)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _ZERO_INIT:
            p.zero_()
            continue
        scale = 0.02 if name == "emb" else 1.0 / math.sqrt(p.shape[-2])
        p.copy_(torch.randn(p.shape, generator=g, device=dev,
                            dtype=torch.float32) * scale)
    return model


def _embed(model: DecoderLM, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = F.embedding(tokens, model.emb).to(torch.bfloat16)
    nv = model.cfg.n_vision_tokens
    if nv and extra_embeds is not None:
        x[:, :nv] += extra_embeds.to(torch.bfloat16) @ model.vis_proj
    return x


def forward(model: DecoderLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V)."""
    x = _embed(model, tokens, extra_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for blk in model.blocks:
        x, _ = blk(x, positions)
    return L.apply_norm(model.cfg.norm, x, model.ln_f) @ model.head()


def empty_cache(cfg, B: int, S: int, device=None) -> Cache:
    """Zero KV cache, (L, B, S, Hkv, hd) bf16 for k and v."""
    check_family(cfg)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def _pad_attn_cache(cache: Cache, S_total: int) -> Cache:
    """Grow prefill (k, v) of length S (axis 2) to the full cache length."""
    def pad(a):
        return F.pad(a, (0, 0, 0, 0, 0, max(S_total - a.shape[2], 0)))
    return {"k": pad(cache["k"]), "v": pad(cache["v"])}


def prefill(model: DecoderLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None):
    """Run the prompt (B, S): returns (last-token logits (B, 1, V), caches
    padded to ``cache_len``)."""
    S = tokens.shape[1]
    x = _embed(model, tokens, extra_embeds)
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for blk in model.blocks:
        x, (k, v) = blk(x, positions)
        ks.append(k)
        vs.append(v)
    caches = _pad_attn_cache({"k": torch.stack(ks), "v": torch.stack(vs)},
                             cache_len or S)
    x = L.apply_norm(model.cfg.norm, x[:, -1:, :], model.ln_f)
    return x @ model.head(), caches


def decode_step(model: DecoderLM, caches: Cache, token: torch.Tensor,
                pos: int):
    """token (B, 1), one position ``pos`` for every lane -> (logits (B, 1,
    V), caches). The caches are updated in place and returned."""
    x = F.embedding(token, model.emb).to(torch.bfloat16)
    positions = torch.tensor([pos], device=token.device)
    for i, blk in enumerate(model.blocks):
        x = blk.decode(x, caches["k"][i], caches["v"][i], pos, positions)
    return L.apply_norm(model.cfg.norm, x, model.ln_f) @ model.head(), caches
