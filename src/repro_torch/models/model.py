"""Family-dispatching model facade: init / loss / prefill / decode / cache.

Counterpart of ``repro.models.model``. ``params`` is the model module: a
:class:`~repro_torch.models.lm.DecoderLM` for the dense, MoE, SSM and
hybrid families, a :class:`~repro_torch.models.seq2seq.EncDecLM` for the
encoder-decoder one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import lm, seq2seq


def init_params(cfg, seed: int = 0, device=None):
    if cfg.family == "encdec":
        return seq2seq.init_params(cfg, seed, device)
    return lm.init_params(cfg, seed, device)


def loss_fn(cfg, params, batch) -> torch.Tensor:
    """The training loss of ``batch`` (``tokens``, ``labels`` and, for a
    vision arch, ``patches``; for an encoder-decoder, ``frames``): the
    cross entropy, plus 0.01 times an MoE model's load-balancing loss."""
    if cfg.family == "encdec":
        return seq2seq.loss_fn(params, batch)
    return lm.loss_fn(params, batch, aux_weight=0.01)


def prefill_fn(cfg, params, batch, cache_len=None):
    if cfg.family == "encdec":
        return seq2seq.prefill(params, batch["frames"], batch["tokens"],
                               cache_len=cache_len)
    return lm.prefill(params, batch["tokens"], batch.get("patches"),
                      cache_len=cache_len)


def decode_fn(cfg, params, caches, token, pos: int):
    if cfg.family == "encdec":
        return seq2seq.decode_step(params, caches, token, pos)
    return lm.decode_step(params, caches, token, pos)


def empty_cache(cfg, B: int, S: int, S_enc: Optional[int] = None,
                device=None):
    """Zero cache for B sequences of S positions; an encoder-decoder's
    encoder states take ``S_enc`` (default S)."""
    if cfg.family == "encdec":
        return seq2seq.empty_cache(cfg, B, S, S_enc or S, device)
    return lm.empty_cache(cfg, B, S, device)
