"""Parameter and cache sharding rules.

Counterpart of ``repro.parallel.sharding``: FSDP over "data", tensor
parallelism over "model", pure data parallelism over "pod"; the rules
key on a leaf's path and fall back to replication where a dimension does
not divide (``filter_spec``). The port's leaves are its parameter names
(``model.named_parameters()``) and its cache dicts. The port holds each
layer on its own (``blocks.{i}.x``), where the reference stacks a leaf
over a leading layer axis, so a port leaf's spec is the reference's
stacked leaf's without its leading ``None``. Specs are tuples;
``parallel.api.named`` turns one into DTensor placements.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from repro_torch.parallel.api import Mesh, filter_spec

# trailing-dims rules keyed by leaf name
_COL = ("data", "model")          # (D, X): FSDP rows, TP cols
_ROW = ("model", "data")          # (X, D)
_RULES = {
    "emb": ("model", "data"),
    "lm_head": _COL,
    "wq": _COL, "wk": _COL, "wv": _COL, "w1": _COL, "w3": _COL,
    "in_proj": _COL, "router": ("data", None),
    "wo": _ROW, "w2": _ROW, "out_proj": _ROW,
    "conv_w": ("model", None),
}
_MOE_RULES = {  # expert-parallel: experts over "model"
    "w1": ("model", "data", None),
    "w3": ("model", "data", None),
    "w2": ("model", None, "data"),
}


def spec_for_leaf(name: str, ndim: int) -> tuple:
    """The unfiltered spec of the parameter ``name`` (dotted) of ``ndim``
    dimensions: its rule on the trailing dimensions, the MoE's own rule
    inside an ``moe`` that is not its ``shared`` expert, else all
    ``None``."""
    names = name.split(".")
    leaf = names[-1]
    in_moe = "moe" in names and "shared" not in names
    rule = (_MOE_RULES if in_moe and leaf in _MOE_RULES else _RULES).get(leaf)
    if rule is None or ndim < len(rule):
        return (None,) * ndim
    return (None,) * (ndim - len(rule)) + tuple(rule)


def param_specs(model: torch.nn.Module, mesh: Mesh) -> Dict[str, tuple]:
    """Each parameter's spec on ``mesh``, by name."""
    return {n: filter_spec(spec_for_leaf(n, p.ndim), mesh, p.shape)
            for n, p in model.named_parameters()}


def cache_spec_for_leaf(name: str, shape: Sequence[int], mesh: Mesh
                        ) -> tuple:
    """KV and SSM cache specs for decode.

    attn caches (..., B, S, Hkv, hd): batch over (pod, data) when it
    divides and B > 1, else sequence over data; heads over model when
    they divide, else head_dim. ssm caches: conv (..., B, K-1, C) and ssm
    (..., B, H, P, N), batch over (pod, data), channels or heads over
    model. Any other leaf (an encoder-decoder's ``ek``, ``ev``): ()."""
    nd = len(shape)
    if name in ("k", "v"):
        B, _, Hkv, _ = shape[-4:]
        batch_total = mesh.size // mesh.axis_size("model")
        spec = [None] * (nd - 4)
        if B % batch_total == 0 and B > 1:
            spec += [("pod", "data"), None]
        else:
            spec += [None, "data"]
        spec += ["model", None] if Hkv % mesh.axis_size("model") == 0 \
            else [None, "model"]
    elif name == "conv":
        spec = [None] * (nd - 3) + [("pod", "data"), None, "model"]
    elif name == "ssm":
        spec = [None] * (nd - 4) + [("pod", "data"), "model", None, None]
    else:
        return ()
    return filter_spec(spec, mesh, shape)


def cache_specs(cache: Mapping[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, tuple]:
    """Each cache tensor's spec on ``mesh``, by name."""
    return {n: cache_spec_for_leaf(n, t.shape, mesh)
            for n, t in cache.items()}
