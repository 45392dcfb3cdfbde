"""Stand-ins and specs of every dry-run cell's inputs.

Counterpart of ``repro.launch.specs``. Where the reference returns
``ShapeDtypeStruct``s and ``NamedSharding``s, this returns tensors on the
``meta`` device (nothing is allocated) and spec tuples resolved by the
port's ``filter_spec`` on a described mesh, keyed as the port keys them:
parameters and AdamW moments by parameter name (one entry a layer where
the reference stacks layers), batches and caches by name.
:func:`local_shape` gives what one device holds of a tensor under its
spec.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.lm import DecoderLM
from repro_torch.models.seq2seq import EncDecLM
from repro_torch.parallel.api import Mesh, filter_spec
from repro_torch.parallel.sharding import cache_specs, param_specs

BATCH = ("pod", "data")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def local_shape(shape, spec: tuple, mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec``: each
    dimension divided by the sizes of the axes its entry names (the
    spec has been filtered, so each divides)."""
    out = list(shape)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)) if e else ():
            out[i] //= mesh.axis_size(a)
    return tuple(out)


def batch_specs(cfg, shape, mesh: Mesh):
    """Training or prefill batch tensors and their specs: tokens (and
    labels for training) int32 (B, S), an encoder-decoder's frames and a
    vision arch's patches bf16; rows over ("pod", "data"), or for a
    batch of one row the sequence over "data"."""
    B, S = shape.global_batch, shape.seq_len

    def sh(spec, shp):
        return filter_spec(spec, mesh, shp)
    batch: Dict[str, torch.Tensor] = {}
    shard: Dict[str, tuple] = {}
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        shard["frames"] = sh((BATCH, None, None), batch["frames"].shape)
    batch["tokens"] = _meta((B, S), torch.int32)
    shard["tokens"] = sh((BATCH, None), (B, S))
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
        shard["labels"] = sh((BATCH, None), (B, S))
    if cfg.n_vision_tokens:
        batch["patches"] = _meta((B, cfg.n_vision_tokens, cfg.d_model),
                                 torch.bfloat16)
        shard["patches"] = sh((BATCH, None, None), batch["patches"].shape)
    if B == 1:  # long-context: sequence-parallel over data
        shard["tokens"] = sh((None, "data"), (B, S))
        if "frames" in batch:
            shard["frames"] = sh((None, "data", None), batch["frames"].shape)
    return batch, shard


def model_state_specs(cfg, mesh: Mesh):
    """(params, their specs, the AdamW state, its specs): the parameters
    by name on ``meta``; the moments ``m`` and ``v`` float32 beside each
    with the parameter's spec, and ``step`` int32 replicated (the
    reference's ``with_opt=True``)."""
    model = (EncDecLM if cfg.family == "encdec" else DecoderLM)(cfg, "meta")
    params = dict(model.named_parameters())
    pspec = param_specs(model, mesh)

    def moments():
        return {n: _meta(p.shape, torch.float32) for n, p in params.items()}
    opt = {"m": moments(), "v": moments(),
           "step": _meta((), torch.int32)}
    ospec = {"m": dict(pspec), "v": dict(pspec), "step": ()}
    return params, pspec, opt, ospec


def decode_specs(cfg, shape, mesh: Mesh):
    """((token, pos, caches), (their specs)) of one decode step: token
    int32 (B, 1) over ("pod", "data"), pos an int32 scalar, and the empty
    cache of ``B`` sequences of ``S`` positions (an encoder-decoder's
    encoder states ``S`` long) with ``parallel.sharding.cache_specs``."""
    B, S = shape.global_batch, shape.seq_len
    caches = M.empty_cache(cfg, B, S, S_enc=S if cfg.family == "encdec"
                           else None, device="meta")
    token = _meta((B, 1), torch.int32)
    pos = _meta((), torch.int32)
    return (token, pos, caches), (filter_spec((BATCH, None), mesh, (B, 1)),
                                  (), cache_specs(caches, mesh))
