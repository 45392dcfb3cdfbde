"""Step functions of the launchers: train_step, prefill_step, serve_step.

Counterpart of ``repro.launch.steps``. The reference returns functions
for ``jax.jit``; these run eagerly, and the train step updates the model
and optimizer state in place (``train.loop.make_step``).
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, make_step


def make_train_step(cfg, opt_cfg: adamw.OptConfig = None):
    """``train_step(model, opt_state, batch)``; 4 microbatches when the
    config sets ``opt_microbatch4``."""
    opt_cfg = opt_cfg or adamw.OptConfig()
    mb = 4 if getattr(cfg, "opt_microbatch4", False) else 1
    return make_step(cfg, opt_cfg, TrainConfig(microbatches=mb))


def _sharded(params) -> bool:
    from repro_torch.parallel.spmd import ShardedEncDec, ShardedLM
    return isinstance(params, (ShardedLM, ShardedEncDec))


def make_prefill_step(cfg):
    """``prefill_step(params, batch) -> (logits, caches)``: the prompt
    (an encoder-decoder's with its ``frames``) through
    ``model.prefill_fn``, or, where ``params`` is one rank's
    ``parallel.spmd.ShardedLM`` or ``ShardedEncDec``, through its
    sharded prefill of the rank's rows (its blocks of the logits and
    caches)."""
    def prefill_step(params, batch):
        if _sharded(params):
            return params.prefill(batch)
        logits, caches = M.prefill_fn(cfg, params, batch)
        return logits, caches

    return prefill_step


def make_serve_step(cfg):
    """One new token against a seq_len-deep cache (decode shapes), through
    ``model.decode_fn`` or a sharded model's decode step, which takes
    the whole cache's ``specs`` (``sharding.cache_specs``: where a B = 1
    decode's rows are whole and its sequence lies over "data"); the
    caches are advanced in place and returned."""
    def serve_step(params, token, pos, caches, specs=None):
        if _sharded(params):
            return params.decode_step(caches, token, pos, specs)
        logits, caches = M.decode_fn(cfg, params, caches, token, pos)
        return logits, caches

    return serve_step
