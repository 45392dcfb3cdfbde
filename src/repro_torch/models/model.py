"""Family-dispatching model facade: init / prefill / decode / cache.

Counterpart of ``repro.models.model``. ``params`` is the
:class:`~repro_torch.models.lm.DecoderLM` module. Only the dense family
runs in the port so far; the others raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.models import lm


def init_params(cfg, seed: int = 0, device=None) -> lm.DecoderLM:
    return lm.init_params(cfg, seed, device)


def prefill_fn(cfg, params: lm.DecoderLM, batch, cache_len=None):
    lm.check_family(cfg)
    return lm.prefill(params, batch["tokens"], batch.get("patches"),
                      cache_len=cache_len)


def decode_fn(cfg, params: lm.DecoderLM, caches, token, pos: int):
    lm.check_family(cfg)
    return lm.decode_step(params, caches, token, pos)


def empty_cache(cfg, B: int, S: int, device=None):
    return lm.empty_cache(cfg, B, S, device)
