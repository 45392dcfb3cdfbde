"""Decoder-only LM of the dense, MoE, SSM and hybrid families: init,
the training forward and loss, prefill and decode.

Counterpart of ``repro.models.lm``. The layers are one ``nn.ModuleList``
``blocks`` in absolute layer order, run by a Python loop; each is a
:class:`Block` of a mixer (attention or Mamba) and an FFN (none, a GLU MLP
or an MoE), as the reference's layer plan (``_plan``) gives them.
Parameters keep the reference's leaf names: ``blocks.{i}.attn.wq`` is the
reference's ``head_blocks[i]`` (the first ``first_k_dense`` layers), its
stacked ``blocks`` at ``i - first_k_dense``, or for a hybrid its
``blocks.sub{i % period}`` at ``i // period``; ``convert`` maps them.

The cache is a dict of stacked tensors, one row per layer of the kind
that uses it, in layer order (:func:`cache_rows`): ``"k"`` and ``"v"``
(L_attn, B, S, Hkv, hd) bf16 for attention layers, ``"conv"`` (L_mamba,
B, K-1, C) bf16 and ``"ssm"`` (L_mamba, B, H, P, N) float32 for Mamba
layers. :func:`decode_step` advances it in place.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts, noop_context_fn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]
Kind = Tuple[str, Optional[str]]


def layer_kinds(cfg) -> List[Kind]:
    """(mixer, ffn) of every layer in absolute order: the reference's
    ``_plan`` unrolled. A hybrid repeats the kinds of its first
    ``hybrid_period`` layers over ``n_layers // hybrid_period``
    super-blocks; the other families take ``first_k_dense`` head layers
    and a body whose layers must all be of one kind."""
    if cfg.family == "hybrid":
        subs = [(cfg.mixer_kind(i), cfg.ffn_kind(i))
                for i in range(cfg.hybrid_period)]
        return subs * (cfg.n_layers // cfg.hybrid_period)
    kinds = [(cfg.mixer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.n_layers)]
    body = kinds[cfg.first_k_dense:]
    if any(k != body[0] for k in body):
        raise ValueError(f"{cfg.name}: body layers must be of one kind")
    return kinds


def cache_rows(kinds: List[Kind]) -> List[int]:
    """Each layer's row in the cache tensors of its mixer."""
    seen = {"attn": 0, "mamba": 0}
    rows = []
    for mixer, _ in kinds:
        rows.append(seen[mixer])
        seen[mixer] += 1
    return rows


class Block(nn.Module):
    """One pre-norm layer: ``ln1`` and a mixer (``attn`` or ``mamba``),
    then, unless ``ffn`` is None, ``ln2`` and an ``mlp`` or ``moe``."""

    def __init__(self, cfg, mixer: str = "attn", ffn: Optional[str] = "mlp",
                 device=None):
        super().__init__()
        self.cfg, self.mixer, self.ffn = cfg, mixer, ffn
        self.ln1 = L.new_param(cfg.d_model, device=device)
        if mixer == "attn":
            self.attn = L.Attention(cfg, device)
        else:
            self.mamba = L.Mamba(cfg, device)
        if ffn is not None:
            self.ln2 = L.new_param(cfg.d_model, device=device)
            if ffn == "moe":
                self.moe = L.MoE(cfg, device)
            else:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, device)

    def _ffn(self, x: torch.Tensor, decode: bool = False):
        """x plus the FFN of ``ln2(x)``, and the MoE's aux loss (None
        without an MoE). The MoE dispatches per data shard
        (``moe_ffn_local``) under ``cfg.opt_moe_local_dispatch``, except in
        a decode step, as the reference's ``_layer_decode``."""
        if self.ffn is None:
            return x, None
        h = L.apply_norm(self.cfg.norm, x, self.ln2)
        if self.ffn == "moe":
            local = self.cfg.opt_moe_local_dispatch and not decode
            moe = L.moe_ffn_local if local else L.moe_ffn
            f, aux = moe(self.moe, h, self.cfg)
            return x + f, aux
        return x + self.mlp(h), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full sequence for training: (x, aux or None), no cache;
        attention through ``layers.blocked_attention``."""
        h = L.apply_norm(self.cfg.norm, x, self.ln1)
        if self.mixer == "attn":
            a = self.attn.blocked(h, positions)
        else:
            a = L.mamba_block(self.mamba, h, self.cfg)
        return self._ffn(x + a)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor):
        """Full sequence for prefill: (x, aux or None, this layer's cache:
        {"k", "v"} (B, S, Hkv, hd) or {"conv", "ssm"}); attention through
        the flash kernel."""
        h = L.apply_norm(self.cfg.norm, x, self.ln1)
        if self.mixer == "attn":
            a, (k, v) = self.attn(h, positions)
            cache = {"k": k, "v": v}
        else:
            a, cache = L.mamba_block(self.mamba, h, self.cfg,
                                     return_cache=True)
        x, aux = self._ffn(x + a)
        return x, aux, cache

    def decode(self, x: torch.Tensor, caches: Cache, row: int, pos: int,
               positions: torch.Tensor) -> torch.Tensor:
        """One step; advances this layer's ``row`` of ``caches`` in place."""
        h = L.apply_norm(self.cfg.norm, x, self.ln1)
        if self.mixer == "attn":
            a = self.attn.decode(h, caches["k"][row], caches["v"][row], pos,
                                 positions)
        else:
            a = L.mamba_decode(self.mamba, h, self.cfg, caches["conv"][row],
                               caches["ssm"][row])
        return self._ffn(x + a, decode=True)[0]


class DecoderLM(nn.Module):
    """Parameters of a decoder-only LM, uninitialised (see
    :func:`init_params` and ``convert.params_from_jax``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name} is an encoder-decoder: "
                             "models.seq2seq.EncDecLM holds it")
        D, V = cfg.d_model, cfg.vocab
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        self.rows = cache_rows(self.kinds)
        self.emb = L.new_param(V, D, device=device)
        self.ln_f = L.new_param(D, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = L.new_param(D, V, device=device)
        if cfg.n_vision_tokens:
            self.vis_proj = L.new_param(D, D, device=device)
        self.blocks = nn.ModuleList(Block(cfg, m, f, device)
                                    for m, f in self.kinds)

    def head(self) -> torch.Tensor:
        return self.emb.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg, seed: int = 0, device=None) -> DecoderLM:
    """Random weights on ``device`` (``None`` = CUDA) with the reference's
    distributions (:func:`layers.init_weights_`)."""
    return L.init_weights_(DecoderLM(cfg, resolve_device(device)), seed)


def _embed(model: DecoderLM, tokens: torch.Tensor,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = F.embedding(tokens, model.emb).to(torch.bfloat16)
    nv = model.cfg.n_vision_tokens
    if nv and extra_embeds is not None:
        x[:, :nv] += extra_embeds.to(torch.bfloat16) @ model.vis_proj
    return x


# the products with no batch dimension: the reference's dot_generals that
# ``dots_with_no_batch_dims_saveable`` keeps (a batched einsum is a bmm)
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The remat policy of ``cfg.opt_remat_dots``: keep the outputs of 2-D
    products, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_plan(cfg) -> List[Optional[str]]:
    """How the training forward runs each unit, as the reference's plan
    (``scan_blocks`` in ``repro.models.lm.forward``). A unit is a layer,
    or for a hybrid a super-block of ``hybrid_period`` layers, the
    reference's scan body. None (no remat) for the ``first_k_dense`` head
    layers and everything without ``cfg.remat``; ``"plain"`` (recompute
    the whole unit) for a hybrid's super-blocks and a flat body without
    ``cfg.opt_remat_dots``; ``"dots"`` (keep :data:`DOTS`' outputs) for a
    flat body with it."""
    n = len(layer_kinds(cfg))
    if cfg.family == "hybrid":
        return [("plain" if cfg.remat else None)] * (n // cfg.hybrid_period)
    if not cfg.remat:
        return [None] * n
    body = "dots" if cfg.opt_remat_dots else "plain"
    return [None] * cfg.first_k_dense + [body] * (n - cfg.first_k_dense)


def run_layers(blocks: nn.ModuleList, x: torch.Tensor,
               positions: torch.Tensor, aux: torch.Tensor):
    """One unit of :func:`remat_plan`, its layers in order (for a hybrid
    the reference's scan body): (x, ``aux`` plus their aux losses, added
    one by one)."""
    for blk in blocks:
        x, a = blk(x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def run_blocks(model: DecoderLM, x: torch.Tensor, positions: torch.Tensor):
    """The training forward's layers on the embedded x: (x, the MoE
    layers' aux loss summed in float32). Each unit of :func:`remat_plan`
    runs under ``torch.utils.checkpoint`` as the plan says, which keeps
    only the unit's inputs, and is recomputed in the backward, whole or
    but for the 2-D products it kept. An MoE layer's collectives
    (parallel.api, on a mesh spread over processes) run again in the
    recompute: every rank recomputes the same layers in the same order."""
    cfg = model.cfg
    per = cfg.hybrid_period if cfg.family == "hybrid" else 1
    dots = functools.partial(create_selective_checkpoint_contexts, save_dots)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, remat in enumerate(remat_plan(cfg)):
        unit = functools.partial(run_layers,
                                 model.blocks[i * per:(i + 1) * per])
        if remat is None:
            x, aux = unit(x, positions, aux)
        else:
            x, aux = checkpoint(unit, x, positions, aux, use_reentrant=False,
                                context_fn=dots if remat == "dots"
                                else noop_context_fn)
    return x, aux


def forward(model: DecoderLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None):
    """The training forward: tokens (B, S) -> (logits (B, S, V), the MoE
    layers' aux loss summed in float32). Attention runs
    ``layers.blocked_attention``, which autograd differentiates; the
    layers run through :func:`run_blocks`."""
    x = _embed(model, tokens, extra_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, aux_total = run_blocks(model, x, positions)
    return L.apply_norm(model.cfg.norm, x, model.ln_f) @ model.head(), \
        aux_total


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 0.0) -> torch.Tensor:
    """Mean token cross entropy in float32: ``logsumexp`` less the label's
    logit, plus ``z_weight`` times the mean squared ``logsumexp``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_weight:
        loss = loss + z_weight * (lse ** 2).mean()
    return loss


def loss_fn(model: DecoderLM, batch, aux_weight: float = 0.01
            ) -> torch.Tensor:
    """Cross entropy of ``batch["tokens"]`` against ``batch["labels"]``
    (``batch["patches"]`` the vision prefix, if any) plus ``aux_weight``
    times the aux loss."""
    logits, aux = forward(model, batch["tokens"], batch.get("patches"))
    return cross_entropy(logits, batch["labels"]) + aux_weight * aux


def empty_cache(cfg, B: int, S: int, device=None) -> Cache:
    """Zero cache for B sequences of up to S positions (module docstring)."""
    kinds = layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_mamba = len(kinds) - n_attn
    dev = resolve_device(device)
    out = {}
    if n_attn:
        shape = (n_attn, B, S, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        out["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if n_mamba:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        out["conv"] = torch.zeros((n_mamba, B, cfg.ssm_conv - 1, conv_dim),
                                  dtype=torch.bfloat16, device=dev)
        out["ssm"] = torch.zeros((n_mamba, B, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev)
    return out


def pad_seq(a: torch.Tensor, S_total: int) -> torch.Tensor:
    """Grow a stacked (L, B, S, H, hd) cache to S_total positions."""
    return F.pad(a, (0, 0, 0, 0, 0, max(S_total - a.shape[2], 0)))


def prefill(model: DecoderLM, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None):
    """Run the prompt (B, S): returns (last-token logits (B, 1, V), the
    cache with k and v padded to ``cache_len``)."""
    S = tokens.shape[1]
    x = _embed(model, tokens, extra_embeds)
    positions = torch.arange(S, device=tokens.device)
    per: Dict[str, List[torch.Tensor]] = {}
    for blk in model.blocks:
        x, _, c = blk.prefill(x, positions)
        for name, t in c.items():
            per.setdefault(name, []).append(t)
    caches = {name: torch.stack(ts) for name, ts in per.items()}
    for name in ("k", "v"):
        if name in caches:
            caches[name] = pad_seq(caches[name], cache_len or S)
    x = L.apply_norm(model.cfg.norm, x[:, -1:, :], model.ln_f)
    return x @ model.head(), caches


def decode_step(model: DecoderLM, caches: Cache, token: torch.Tensor,
                pos: int):
    """token (B, 1), one position ``pos`` for every lane -> (logits (B, 1,
    V), caches). The caches are updated in place and returned."""
    x = F.embedding(token, model.emb).to(torch.bfloat16)
    positions = torch.tensor([pos], device=token.device)
    for blk, row in zip(model.blocks, model.rows):
        x = blk.decode(x, caches, row, pos, positions)
    return L.apply_norm(model.cfg.norm, x, model.ln_f) @ model.head(), caches
