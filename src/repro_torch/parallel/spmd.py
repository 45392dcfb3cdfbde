"""The sharded training, prefill and decode steps of every LM family:
FSDP over "data" (HSDP over "pod") and tensor parallelism over
"model".

Counterpart of what ``jax.jit(train_step, in_shardings=...)`` makes of
the reference's step in its dry run (``repro.launch.dryrun.build_lowered``):
the step sharded as ``parallel.sharding``'s rules say. The models see
only plain tensors; no DTensor does arithmetic here.

State. A rank holds exactly its block of every parameter under its spec
(``sharding.param_specs`` through ``filter_spec``), so its parameters,
AdamW moments and batch rows are the bytes the reference's program
holds on a device. The dimension a spec puts on "model" is cut to the
rank's block when the module is built; the dimension it puts on "data"
is sharded by FSDP2's ``fully_shard`` (``Shard(dim)``, one unit a layer
and one for the root, HSDP with "pod"); a parameter whose spec names no
"data" (norms, biases, ``vis_proj``, Mamba's ``conv_w`` and its f32
leaves) is FSDP's ignored parameter, replicated over the batch ranks,
its gradient averaged over them here.

Compute over "model" by local shapes, the Megatron pattern. Collectives
sit at module boundaries (``parallel.api``: ``column_input``, identity
forward and all-reduce backward, where a column-parallel product takes
its input; ``row_output``, all-reduce forward, where a row-parallel one
gives its output):
- attention: each rank runs its block of q heads when the heads divide
  over "model", and the kv heads those q heads read (GQA: qwen2.5-3b's 2
  kv heads over 16 ranks give each rank one whole kv head, where its
  stored block of ``wk`` is 16 columns). A weight whose stored block is
  not what the rank computes with is gathered over "model" inside the
  step and its gradient reduce-scattered back (:class:`_ModelView`); a
  replicated bias is sliced and its gradient summed. Where the q heads
  do not divide (qwen1.5-32b's 40 over 16), every rank runs all heads
  on the gathered weights, and keeps its block of their (equal)
  gradients. An encoder's self attention is the same, non-causal; a
  decoder's cross attention reads the encoder's states through
  ``column_input``;
- the Mamba2 mixer: each rank runs its block of the SSM heads where
  they divide. ``in_proj``'s stored block of columns cuts across its
  ``[z | x | B | C | dt]`` fields (and ``conv_w``'s rows across ``[x |
  B | C]``), so both are gathered whole over "model" and the rank takes
  its heads' z, x and dt and all of the B and C its heads read; the
  replicated ``conv_b``, ``dt_bias``, ``A_log``, ``D`` and ``norm_w``
  are sliced to its heads and channels. The gated norm runs over all of
  ``d_inner``: each row's f32 sum of squares is summed over the model
  group. ``out_proj``'s block of rows is the rank's heads;
- the GLU MLP (and an MoE's shared experts): columns of ``w1``/``w3``
  and rows of ``w2`` where ``d_ff`` divides;
- the vocabulary where it divides: a vocab-parallel embedding (each rank
  looks up its rows, zeros elsewhere, summed over "model", exact) and a
  vocab-parallel cross entropy (max, sum of exponentials and the label's
  logit all-reduced), else replicated;
- the MoE: experts over "model" (``_MOE_RULES``), the router replicated,
  through ``layers.moe_ffn_ep``. Every rank of a model group already
  holds its data shard's tokens, so the dispatch needs no all-to-all:
  each rank routes all tokens, runs its own experts, and the partial
  combine is all-reduced (f32). The dispatch keeps ``_Dispatch``'s fixed
  summation order. Capacity and routing are per data shard, as
  ``moe_ffn_local``'s.

Serving (``prefill`` and ``decode_step`` of every family, forward only):
the same modules called in a prefill or decode mode, so FSDP gathers a
layer as in training, on the rank's rows. The rank keeps exactly its
block of the cache under ``sharding.cache_specs``:
- k and v: its kv heads where they divide over "model" (those its q
  heads read), else columns of every kv head's ``head_dim``. In that
  second layout a prefill computes k and v of every kv head from the
  weights gathered whole and keeps its columns; a decode step computes
  q, k and v of every head, sums the scores' partial products over the
  rank's columns across the model group (an f32 all-reduce of (B, H,
  S) a layer) before the softmax, runs P.V on its columns and sums its
  part of the output projection. Where the rows do not split over the
  batch axes (a B = 1 decode) the sequence lies over "data": only the
  rank whose positions hold ``pos`` writes it, and the softmax spans
  the data ranks (an f32 max and sum all-reduced, P.V summed). No
  k or v cache is gathered;
- a Mamba layer's ``ssm`` state: the rank's heads; its ``conv`` window:
  the spec's contiguous block of the C conv channels, which is not the
  channels its heads compute with (their x channels and the B and C
  they read). A prefill computes the raw conv inputs of the block at the
  last K - 1 positions from ``in_proj`` (gathered whole); a decode step
  all-gathers the layer's (B, K - 1, C) window over "model", convolves
  its own channels with the new position's raw inputs of all C, and
  writes back its block;
- an encoder-decoder's ``ek`` and ``ev``: whole on every rank (their
  spec is ``()``, as XLA's output shardings make them), gathered over
  the model heads and the batch rows by the prefill; a decode step's
  cross attention reads its rows and kv heads of them.
Prefill attention runs the flash kernel (``layers.gqa_attention``): an
encoder's non-causal, a decoder's causal self attention and its
non-causal cross attention. The logits are the last position's, the
rank's vocabulary block where it divides. Rows that do not split over
the batch axes are held whole on every batch rank, and nothing is summed
over the batch groups then (each holds the same rows).

Every collective of the step (FSDP2's own included) goes through the
c10d dispatcher, where :class:`Recorder` logs it. At world size 1 on a
(1, 1) mesh the step is ``train.loop.make_step``'s bit for bit, and the
prefill and decode steps ``model.prefill_fn``'s and ``decode_fn``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L, lm, seq2seq
from repro_torch.optim import adamw
from repro_torch.parallel import api
from repro_torch.parallel.api import BATCH_AXES, Mesh, filter_spec
from repro_torch.parallel.sharding import cache_spec_for_leaf, \
    spec_for_leaf

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
AUX_WEIGHT = 0.01


def _axes(entry) -> Tuple[str, ...]:
    return (entry if isinstance(entry, tuple) else (entry,)) if entry else ()


def coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each axis of ``mesh`` (row-major, as
    ``init_device_mesh`` lays ranks out)."""
    out = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.shape))):
        out[name] = rank % size
        rank //= size
    return out


def cut(t: torch.Tensor, spec: tuple, mesh: Mesh, at: Dict[str, int],
        only: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
    """The block of ``t`` under ``spec`` at mesh position ``at`` (a view):
    each dimension cut over the axes its entry names (``only`` those
    in ``only``), the first axis the major one."""
    for i, e in enumerate(spec):
        n, idx = 1, 0
        for a in _axes(e):
            if only is None or a in only:
                n, idx = n * mesh.axis_size(a), idx * mesh.axis_size(a) + at[a]
        if n > 1:
            size = t.shape[i] // n
            t = t.narrow(i, idx * size, size)
    return t


def specs(model: nn.Module, mesh: Mesh) -> Dict[str, tuple]:
    """Each parameter's filtered spec, by name; ``model`` holds the whole
    model's shapes."""
    return {n: filter_spec(spec_for_leaf(n, p.ndim), mesh, p.shape)
            for n, p in model.named_parameters()}


def shard_state(model: nn.Module, mesh: Mesh, rank: int
                ) -> Dict[str, torch.Tensor]:
    """The whole model's parameters (by name) cut into rank ``rank``'s
    shards on ``mesh``: what the rank's sharded model holds."""
    at = coords(mesh, rank)
    return {n: cut(p.detach(), specs(model, mesh)[n], mesh, at).clone()
            for n, p in model.named_parameters()}


def gather_state(shards: List[Dict[str, torch.Tensor]], model: nn.Module,
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole parameters of ``model``'s shapes from every rank's
    shards (``shards[rank]``), the inverse of :func:`shard_state`."""
    spec = specs(model, mesh)
    out = {n: torch.empty(p.shape, dtype=p.dtype)
           for n, p in model.named_parameters()}
    for rank, shard in enumerate(shards):
        at = coords(mesh, rank)
        for n, t in shard.items():
            cut(out[n], spec[n], mesh, at).copy_(t)
    return out


# --- this rank's place and groups -------------------------------------------


class Place:
    """This rank's coordinates on a mesh that holds a DeviceMesh and the
    process group of each axis longer than 1 (None otherwise)."""

    def __init__(self, mesh: Mesh):
        dm = mesh.device_mesh
        if dm is None:
            raise ValueError("the sharded step needs a mesh that holds a "
                             "DeviceMesh (a process group of its size)")
        self.mesh = mesh
        self.at = {a: dm.get_local_rank(a) for a in mesh.axis_names}
        self.group = {a: dm.get_group(a) if mesh.axis_size(a) > 1 else None
                      for a in mesh.axis_names}
        self.m = mesh.axis_size("model")
        self.model = self.group.get("model")
        self.batch = tuple(self.group[a] for a in BATCH_AXES
                           if self.group.get(a) is not None)

    @property
    def batch_shard(self) -> int:
        """The index of this rank's batch shard (pod major, then data)."""
        idx = 0
        for a in BATCH_AXES:
            idx = idx * self.mesh.axis_size(a) + self.at.get(a, 0)
        return idx

    def fsdp_mesh(self):
        """The DeviceMesh FSDP shards over: "data", or ("pod", "data")
        for HSDP (replicated over pod)."""
        dm = self.mesh.device_mesh
        if "pod" in self.mesh.axis_names:
            return dm["pod", "data"]
        return dm["data"]


def rank_rows(batch: Dict[str, torch.Tensor], place: Place
              ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: batch shard ``place.batch_shard``
    of ``mesh.batch_shards`` equal shards of rows, or all of them where
    ``filter_spec`` replicates the rows over the batch axes (a B = 1
    decode's token, as ``specs.decode_specs`` gives it)."""
    mesh = place.mesh
    n = mesh.batch_shards
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n == 0:
            b = v.shape[0] // n
            out[k] = v[place.batch_shard * b:(place.batch_shard + 1) * b]
        elif not filter_spec((BATCH_AXES,), mesh, v.shape[:1]):
            out[k] = v
        else:
            raise ValueError(f"{k}: {v.shape[0]} rows split over some of "
                             f"the batch axes, not all {n} batch shards")
    return out


# --- weights gathered over "model" inside the step ---------------------------


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),)
                      + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _scatter_sum(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


@dataclasses.dataclass(frozen=True)
class View:
    """What a rank computes with, ``need`` (a range of dimension ``dim``
    of the whole tensor, ``size`` long), against what it stores,
    ``stored`` (its block, or None for the whole dimension); ``partial``
    when the ranks' gradients of the range are parts to be summed, not
    equal copies."""
    dim: int
    size: int
    stored: Optional[Tuple[int, int]]
    need: Tuple[int, int]
    partial: bool


class _ModelView(torch.autograd.Function):
    """The ``need`` range of a weight from the rank's stored block:
    gathered over "model" when it is not all held here. The backward
    puts the gradient back in the whole dimension and sums the ranks'
    parts (a reduce-scatter into the block, or an all-reduce of a whole
    replicated tensor), or, where every rank computed the same gradient,
    keeps its own block of it."""

    @staticmethod
    def forward(ctx, t, v: View, group):
        ctx.v, ctx.group, ctx.shape = v, group, t.shape
        full = t if v.stored is None else _gather(t, v.dim, group)
        return full.narrow(v.dim, v.need[0], v.need[1] - v.need[0])

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        v = ctx.v
        shape = list(ctx.shape)
        shape[v.dim] = v.size
        full = g.new_zeros(shape)
        full.narrow(v.dim, v.need[0], v.need[1] - v.need[0]).copy_(g)
        if v.partial:
            if v.stored is None:
                dist.all_reduce(full, group=ctx.group)
                return full, None, None
            return _scatter_sum(full, v.dim, ctx.group), None, None
        if v.stored is None:
            return full, None, None
        return full.narrow(v.dim, v.stored[0],
                           v.stored[1] - v.stored[0]).contiguous(), None, None


class _DataGather(torch.autograd.Function):
    """A weight sharded over "data" by hand (FSDP holds one dtype a unit,
    and the MoE's float32 router shares its unit with bf16 experts):
    all-gathered over "data" forward; the backward reduce-scatters its
    gradient into the shard and averages it over "data" and then "pod",
    as FSDP's reduce-scatter does (either group None: of size 1)."""

    @staticmethod
    def forward(ctx, t, dim: int, data, pod):
        ctx.dim, ctx.data, ctx.pod = dim, data, pod
        return t.view_as(t) if data is None else _gather(t, dim, data)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.data is not None:
            g = _scatter_sum(g, ctx.dim, ctx.data) / \
                dist.get_world_size(ctx.data)
        if ctx.pod is not None:
            g = g.clone()
            dist.all_reduce(g, group=ctx.pod)
            g = g / dist.get_world_size(ctx.pod)
        return g, None, None, None


# --- the modules ------------------------------------------------------------


def _merged(ranges) -> List[List[int]]:
    """The ranges ``[(lo, hi), ...]`` with each one that starts where the
    one before it ends joined to it."""
    merged: List[List[int]] = []
    for lo, hi in ranges:
        if merged and merged[-1][1] == lo:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return merged


def _ranges(t: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """The ranges ``[(lo, hi), ...]`` of dimension ``dim`` of ``t``, in
    order, as one tensor: ``t`` itself where they cover it whole."""
    merged = _merged(ranges)
    if merged == [[0, t.shape[dim]]]:
        return t
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in merged], dim)


class _Viewed:
    """A module whose weights a rank reads through their :class:`View`
    (None: as stored), gathered over ``model_group``."""
    views: Dict[str, Optional[View]] = {}
    model_group = None

    def _w(self, name: str, views=None) -> torch.Tensor:
        v = (self.views if views is None else views).get(name)
        t = getattr(self, name)
        return t if v is None else _ModelView.apply(t, v, self.model_group)


class Attention(_Viewed, L.Attention):
    """A rank's attention: ``hq`` q heads and ``hkv`` kv heads (the
    ``kv`` range of them), each weight through its :class:`View`;
    ``group`` the model group when the heads are split over it, else
    None. Serving (:meth:`prefill`, :meth:`decode`) keeps the rank's
    block of the kv cache under ``sharding.cache_spec_for_leaf``: its kv
    heads, or where the kv heads do not divide over "model", columns
    ``cols`` of every kv head's ``head_dim`` (``whole`` then holds the
    views that gather each weight whole); its positions, where the
    sequence lies over "data" (``data``: that group, None without one,
    and the rank's index on it)."""
    group = None
    hq = hkv = 0
    kv: Tuple[int, int] = (0, 0)
    cols: Optional[Tuple[int, int]] = None
    whole: Dict[str, View] = {}
    data: Tuple = (None, 0)

    def _out(self, q, k, v, causal: bool) -> torch.Tensor:
        o = L.blocked_attention(q, k, v, causal=causal,
                                block=self.cfg.attn_block)
        return api.row_output(o.reshape(*q.shape[:2], -1) @ self._w("wo"),
                              self.group)

    def _flash(self, q, k, v, causal: bool) -> torch.Tensor:
        """The flash kernel (``layers.gqa_attention``) on the rank's heads,
        then its rows of ``wo``, summed over the model group."""
        o = L.gqa_attention(q, k, v, causal=causal)
        return api.row_output(o.reshape(*q.shape[:2], -1) @ self._w("wo"),
                              self.group)

    def _proj(self, x: torch.Tensor, name: str, heads: int,
              views=None) -> torch.Tensor:
        """``x @ w`` (plus its bias) as (B, S, heads, hd) for ``name`` in
        q, k, v, each weight through ``views`` (default the rank's)."""
        cfg = self.cfg
        t = x @ self._w("w" + name, views)
        if cfg.qkv_bias:
            t = t + self._w("b" + name, views)
        return t.view(*x.shape[:2], heads, cfg.head_dim)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """q of this rank's heads and k, v of its kv heads, RoPE on q and
        k: ``L.Attention.qkv``'s ops."""
        cfg = self.cfg
        q, k, v = (self._proj(x, "q", self.hq), self._proj(x, "k", self.hkv),
                   self._proj(x, "v", self.hkv))
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)

    def blocked(self, x: torch.Tensor, positions: torch.Tensor,
                causal: Optional[bool] = None) -> torch.Tensor:
        """``L.Attention.blocked`` on this rank's heads (``causal``: by
        default the config's): the same ops, between ``column_input`` and
        ``row_output``."""
        cfg = self.cfg
        q, k, v = self._qkv(api.column_input(x, self.group), positions)
        return self._out(q, k, v, cfg.causal if causal is None else causal)

    def _whole_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """k and v of every kv head from the weights gathered whole, RoPE
        on k."""
        cfg = self.cfg
        k = self._proj(x, "k", cfg.n_kv_heads, self.whole)
        return (L.apply_rope(k, positions, cfg.rope_theta),
                self._proj(x, "v", cfg.n_kv_heads, self.whole))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                causal: Optional[bool] = None):
        """``L.Attention.forward`` (the flash kernel, through
        ``layers.gqa_attention``; ``causal``: by default the config's) on
        this rank's heads: (out, (k, v) of the rank's cache block). Where
        the cache holds columns, k and v are computed for every kv head,
        the rank's kv heads attend, and its columns of all of them are
        its cache block."""
        cfg = self.cfg
        if self.cols is None:
            q, k, v = self._qkv(x, positions)
            cache = (k, v)
        else:
            q = L.apply_rope(self._proj(x, "q", self.hq), positions,
                             cfg.rope_theta)
            kw, vw = self._whole_kv(x, positions)
            k, v = kw[:, :, self.kv[0]:self.kv[1]], \
                vw[:, :, self.kv[0]:self.kv[1]]
            c0, c1 = self.cols
            cache = (kw[..., c0:c1], vw[..., c0:c1])
        return self._flash(q, k, v, cfg.causal if causal is None
                           else causal), cache

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int, positions: torch.Tensor,
               seq: bool = False) -> torch.Tensor:
        """``L.Attention.decode`` on this rank's cache block (B, S, Hkv,
        hd) of its rows, written at ``pos`` in place. On a block of kv
        heads: the rank's heads, as there. On a block of columns: q, k
        and v of every head from the gathered weights, the scores'
        partial sums over the rank's columns summed over the model group
        before the softmax, P.V on its columns, and its rows of ``wo``
        (gathered whole) give a part of the output that the group sums.
        With ``seq`` the block holds the rank's positions of a sequence
        split over "data" (:func:`_decode_block`), and only the rank
        that holds ``pos`` writes it."""
        cfg = self.cfg
        group, d = self.data if seq else (None, 0)
        first = d * k_cache.shape[1]
        where = pos - first if first <= pos < first + k_cache.shape[1] \
            else None
        if self.cols is None:
            q, k, v = self._qkv(x, positions)
            if where is not None:
                k_cache[:, where] = k[:, 0].to(k_cache.dtype)
                v_cache[:, where] = v[:, 0].to(v_cache.dtype)
            o = _decode_block(q, k_cache, v_cache, pos, None, None,
                              (group, first))
            return api.row_output(o.reshape(x.shape[0], 1, -1)
                                  @ self._w("wo"), self.group)
        c0, c1 = self.cols
        q = L.apply_rope(self._proj(x, "q", cfg.n_heads, self.whole),
                         positions, cfg.rope_theta)
        k, v = self._whole_kv(x, positions)
        if where is not None:
            k_cache[:, where] = k[:, 0, :, c0:c1].to(k_cache.dtype)
            v_cache[:, where] = v[:, 0, :, c0:c1].to(v_cache.dtype)
        o = _decode_block(q, k_cache, v_cache, pos, self.cols,
                          self.model_group, (group, first))
        hd = cfg.head_dim
        wo = _ranges(self._w("wo", self.whole), 0,
                     [(h * hd + c0, h * hd + c1) for h in range(cfg.n_heads)])
        return api.row_output(o.reshape(x.shape[0], 1, -1) @ wo,
                              self.model_group)

    def enc_kv(self, enc_x: torch.Tensor):
        """``seq2seq._enc_kv`` on this rank's kv heads: k and v of the
        encoder's states, which enter through ``column_input``."""
        cfg = self.cfg
        shape = enc_x.shape[:2] + (self.hkv, cfg.head_dim)
        enc_x = api.column_input(enc_x, self.group)
        k = (enc_x @ self._w("wk")).view(shape)
        v = (enc_x @ self._w("wv")).view(shape)
        if cfg.qkv_bias:
            k = k + self._w("bk").view(shape[2:])
            v = v + self._w("bv").view(shape[2:])
        return k, v

    def cross(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              flash: bool = False) -> torch.Tensor:
        """``layers.cross_attention`` (no RoPE, non-causal; blocked, or
        with ``flash`` the flash kernel) on this rank's heads: q from
        ``x`` over :meth:`enc_kv`'s k and v."""
        cfg = self.cfg
        q = (api.column_input(x, self.group) @ self._w("wq")).view(
            x.shape[:2] + (self.hq, cfg.head_dim))
        if cfg.qkv_bias:
            q = q + self._w("bq").view(self.hq, cfg.head_dim)
        return (self._flash if flash else self._out)(q, k, v, False)

    def cross_decode(self, x: torch.Tensor, ek: torch.Tensor,
                     ev: torch.Tensor) -> torch.Tensor:
        """``seq2seq.decode_step``'s cross attention on this rank's heads:
        q of x (B, 1, D) without bias or RoPE over the rank's rows and kv
        heads of the encoder's ``ek`` and ``ev`` (B, S_enc, Hkv, hd), all
        S_enc positions visible."""
        cfg = self.cfg
        q = (api.column_input(x, self.group) @ self._w("wq")).view(
            x.shape[0], 1, self.hq, cfg.head_dim)
        o = L.decode_attention(q, ek[:, :, self.kv[0]:self.kv[1]],
                               ev[:, :, self.kv[0]:self.kv[1]],
                               ek.shape[1] - 1)
        return api.row_output(o.reshape(x.shape[0], 1, -1) @ self._w("wo"),
                              self.group)


def _decode_block(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int,
                  cols: Optional[Tuple[int, int]], model_group, seq
                  ) -> torch.Tensor:
    """``layers.decode_attention`` on a rank's block of the caches (B, S,
    Hkv, c): q (B, 1, Hq, hd), scaled and rounded as there. ``cols``:
    the block holds columns ``cols`` of ``head_dim`` (c = c1 - c0; q is
    every head's), and each score's f32 partial sum over them is summed
    over ``model_group``; None: all of it. ``seq`` = (group, first): the
    block holds positions ``first``.. of a sequence split over
    ``group``, whose softmax spans the group's ranks (the f32 row max
    all-reduced (MAX), the exponentials' sum all-reduced, P rounded to
    the cache's dtype, P.V in f32 summed over it); group None: the
    block holds every position, softmax as there. Positions ``<= pos``
    are visible. Returns (B, 1, Hq, c) in q's dtype."""
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    group, first = seq
    qg = (q * L._scale_in(hd, q.dtype)).reshape(B, Hkv, Hq // Hkv, hd)
    if cols is not None:
        qg = qg[..., cols[0]:cols[1]]
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float())
    if cols is not None:
        s = api.row_output(s, model_group)
    visible = first + torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~visible, L.NEG_INF)
    if group is None:
        p = torch.softmax(s, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bgrk,bkgd->bgrd", p.float(), v_cache.float())
    else:
        import torch.distributed as dist
        mx = s.amax(-1, keepdim=True)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(s - mx)
        p = (e / api.row_output(e.sum(-1, keepdim=True), group)).to(
            v_cache.dtype)
        o = api.row_output(torch.einsum("bgrk,bkgd->bgrd", p.float(),
                                        v_cache.float()), group)
    return o.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


class Mamba(_Viewed, L.Mamba):
    """A rank's Mamba2 mixer: SSM heads ``heads`` (lo, hi) and the B/C
    groups ``groups`` they read; ``in_cols`` and ``conv_rows`` the
    ranges of ``in_proj``'s columns and the conv's channels that the
    rank computes with; ``group`` the model group when the heads are
    split over it. Serving keeps the block ``conv_block`` of the conv
    channels of the conv window (``conv_split``: split over the model
    group) and its heads' SSM state. Unplanned it holds every head:
    ``layers.mamba_block`` bit for bit."""
    group = None
    conv_split = False

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.cfg = cfg
        self.plan((0, cfg.ssm_heads), (0, cfg.ssm_groups))

    def plan(self, heads: Tuple[int, int], groups: Tuple[int, int]) -> None:
        cfg = self.cfg
        P, N, d_in = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
        GN = cfg.ssm_groups * N
        self.heads, self.groups = heads, groups
        x = (heads[0] * P, heads[1] * P)
        bc = (groups[0] * N, groups[1] * N)
        self.conv_rows = (x, (d_in + bc[0], d_in + bc[1]),
                          (d_in + GN + bc[0], d_in + GN + bc[1]))
        dt = 2 * d_in + 2 * GN
        self.in_cols = (x,) + tuple((d_in + lo, d_in + hi)
                                    for lo, hi in self.conv_rows) + \
            ((dt + heads[0], dt + heads[1]),)
        self.conv_block = (0, d_in + 2 * GN)

    def _gated_norm(self, g: torch.Tensor) -> torch.Tensor:
        """``rmsnorm(g, norm_w)`` over all of ``d_inner``: this rank's
        channels' f32 sums of squares summed over the model group."""
        w = self._w("norm_w")
        if self.group is None:
            return L.rmsnorm(g, w)
        gf = g.float()
        ms = api.summed((gf * gf).sum(-1, keepdim=True), self.group) / \
            self.cfg.d_inner
        gf = gf * torch.rsqrt(ms + 1e-6)
        return (gf * (1.0 + w.float())).to(g.dtype)

    def _mixer(self, x: torch.Tensor):
        """``layers.mamba_block``'s ops in its order on this rank's heads,
        between ``column_input`` and ``row_output``: (out, the raw conv
        inputs of its ``conv_rows`` (B, S, ...), its heads' final SSM
        state, the input as it entered, ``in_proj`` as read)."""
        cfg = self.cfg
        B, S, _ = x.shape
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        h, g = self.heads[1] - self.heads[0], self.groups[1] - self.groups[0]
        x = api.column_input(x, self.group)
        w_in = self._w("in_proj")
        z, xbc_raw, dt_raw = torch.split(
            x @ _ranges(w_in, 1, self.in_cols),
            [h * P, h * P + 2 * g * N, h], dim=-1)
        xbc = F.silu(L._causal_conv(
            xbc_raw, _ranges(self._w("conv_w"), 0, self.conv_rows),
            _ranges(self._w("conv_b"), 0, self.conv_rows)))
        xs, Bm, Cm = torch.split(xbc, [h * P, g * N, g * N], dim=-1)
        xh = xs.reshape(B, S, h, P)
        dt = L.softplus(dt_raw.float() + self._w("dt_bias"))
        y, state = L.ssd_chunked(xh, dt, -torch.exp(self._w("A_log")),
                                 Bm.reshape(B, S, g, N),
                                 Cm.reshape(B, S, g, N),
                                 min(cfg.ssm_chunk, S))
        y = y + xh.float() * self._w("D")[:, None]
        y = self._gated_norm(y.reshape(B, S, h * P).to(x.dtype) * F.silu(z))
        out = api.row_output(y @ self._w("out_proj"), self.group)
        return out, xbc_raw, state, x, w_in

    def blocked(self, x: torch.Tensor) -> torch.Tensor:
        """``layers.mamba_block`` (x (B, S, D) -> (B, S, D)) on this
        rank's heads: the same ops in the same order, between
        ``column_input`` and ``row_output``."""
        return self._mixer(x)[0]

    def prefill(self, x: torch.Tensor):
        """``layers.mamba_block(..., return_cache=True)`` on this rank's
        heads: (out, its ``conv_block`` of the raw conv inputs at the
        last K - 1 positions (B, K - 1, c1 - c0), its heads' final state
        (B, h, P, N) f32). The block is cut from the rank's own conv
        inputs where its heads read every channel, else computed from
        ``in_proj``."""
        out, xbc_raw, state, x, w_in = self._mixer(x)
        tail = x.shape[1] - (self.cfg.ssm_conv - 1)
        c0, c1 = self.conv_block
        if _merged(self.conv_rows) == [[0, xbc_raw.shape[-1]]]:
            conv = xbc_raw[:, tail:, c0:c1]
        else:
            d_in = self.cfg.d_inner
            conv = x[:, tail:] @ w_in[:, d_in + c0:d_in + c1]
        return out, conv, state

    def decode(self, x: torch.Tensor, conv: torch.Tensor,
               ssm: torch.Tensor) -> torch.Tensor:
        """``layers.mamba_decode`` on this rank's heads, x (B, 1, D): its
        block of the conv window ``conv`` (B, K - 1, c1 - c0), all-gathered
        over the model group where it is split, and the new position's
        raw inputs of all C channels give the window whose ``conv_rows``
        the rank convolves; it writes back its block of the window and
        its heads' state ``ssm`` (B, h, P, N) in place."""
        cfg = self.cfg
        B = x.shape[0]
        P, N, d_in = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
        C = d_in + 2 * cfg.ssm_groups * N
        h, g = self.heads[1] - self.heads[0], self.groups[1] - self.groups[0]
        x = api.column_input(x, self.group)
        cols = [self.in_cols[0], (d_in, d_in + C), self.in_cols[-1]]
        z, xbc, dt_raw = torch.split(
            x @ _ranges(self._w("in_proj"), 1, cols), [h * P, C, h], dim=-1)
        held = _gather(conv, 2, self.model_group) if self.conv_split \
            else conv
        window = torch.cat([held, xbc], dim=1)               # (B, K, C)
        rows = self.conv_rows
        conv_out = F.silu(torch.einsum(
            "bkc,ck->bc", _ranges(window, 2, rows).float(),
            _ranges(self._w("conv_w"), 0, rows).float())
            + _ranges(self._w("conv_b"), 0, rows).float())
        c0, c1 = self.conv_block
        conv.copy_(window[:, 1:, c0:c1])
        xs, Bm, Cm = torch.split(conv_out, [h * P, g * N, g * N], dim=-1)
        xh = xs.reshape(B, h, P)
        rep = h // g
        dt = L.softplus(dt_raw[:, 0].float() + self._w("dt_bias"))
        y, state = L.ssd_step(
            ssm, xh, dt, -torch.exp(self._w("A_log")),
            Bm.reshape(B, g, N).repeat_interleave(rep, 1),
            Cm.reshape(B, g, N).repeat_interleave(rep, 1))
        ssm.copy_(state)
        y = y + xh * self._w("D")[:, None]
        y = self._gated_norm(y.reshape(B, 1, h * P).to(x.dtype) * F.silu(z))
        return api.row_output(y @ self._w("out_proj"), self.group)


class MLP(L.MLP):
    """A rank's GLU MLP: its columns of ``w1``/``w3`` and rows of ``w2``
    when ``group`` (the model group) splits them; whole without one."""
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return api.row_output(L.glu_mlp(api.column_input(x, self.group),
                                        self.w1, self.w3, self.w2, self.act),
                              self.group)


class Block(lm.Block):
    """``lm.Block`` with this module's attention or Mamba mixer and MLP;
    its MoE runs ``layers.moe_ffn_ep`` over this rank's experts."""
    first_expert = 0
    expert_group = None
    batch_groups: Tuple = ()
    router_gather: Optional[Tuple] = None

    def __init__(self, cfg, mixer: str, ffn: Optional[str]):
        super().__init__(cfg, mixer, ffn, "meta")
        if mixer == "attn":
            self.attn = Attention(cfg, "meta")
        else:
            self.mamba = Mamba(cfg, "meta")
        if ffn == "mlp":
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, "meta")

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mode: str = "train", caches=None, row: int = 0,
                pos: int = 0, layout: Tuple[bool, bool] = (False, False)):
        """The training forward (x, aux); with ``mode`` "prefill" ``(x,
        this layer's cache block)``, ``lm.Block.prefill`` with the rank's
        blocks ({"k", "v"} or {"conv", "ssm"}); with "decode" x after
        ``lm.Block.decode``, which writes the rank's block of ``caches``
        at ``row``, ``pos`` in place, ``layout`` (rows whole, sequence
        over "data") as :meth:`_Sharded._layout` gives it. A call, so
        that FSDP gathers the layer in every mode."""
        if mode != "train":
            h = L.apply_norm(self.cfg.norm, x, self.ln1)
            if mode == "prefill":
                if self.mixer == "attn":
                    a, (k, v) = self.attn.prefill(h, positions)
                    cache = {"k": k, "v": v}
                else:
                    a, conv, ssm = self.mamba.prefill(h)
                    cache = {"conv": conv, "ssm": ssm}
                return self._ffn(x + a)[0], cache
            whole, seq = layout
            if self.mixer == "attn":
                a = self.attn.decode(h, caches["k"][row], caches["v"][row],
                                     pos, positions, seq)
            else:
                a = self.mamba.decode(h, caches["conv"][row],
                                      caches["ssm"][row])
            return self._ffn(x + a, decode=True, whole_rows=whole)[0]
        if self.mixer == "attn":
            return super().forward(x, positions)
        h = L.apply_norm(self.cfg.norm, x, self.ln1)
        return self._ffn(x + self.mamba.blocked(h))

    def _ffn(self, x: torch.Tensor, decode: bool = False,
             whole_rows: bool = False):
        """``lm.Block._ffn``; an MoE through ``moe_ffn_ep``, its aux summed
        over the batch groups unless every batch rank holds the same rows
        (``whole_rows``)."""
        if self.ffn != "moe":
            return super()._ffn(x, decode)
        h = L.apply_norm(self.cfg.norm, x, self.ln2)
        router = None if self.router_gather is None else \
            _DataGather.apply(self.moe.router, *self.router_gather)
        f, aux = L.moe_ffn_ep(self.moe, h, self.cfg, self.first_expert,
                              self.expert_group,
                              () if whole_rows else self.batch_groups, router)
        return x + f, aux


class EncBlock(seq2seq.EncBlock):
    """``seq2seq.EncBlock`` with this module's attention and MLP; called,
    it is ``seq2seq._enc_layer``'s training form on this rank's heads
    (FSDP gathers a layer when it is called), or with ``mode`` "prefill"
    its flash form (non-causal)."""

    def __init__(self, cfg):
        super().__init__(cfg, "meta")
        self.cfg = cfg
        self.attn = Attention(cfg, "meta")
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, "meta")

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mode: str = "train") -> torch.Tensor:
        norm = self.cfg.norm
        h = L.apply_norm(norm, x, self.ln1)
        if mode == "prefill":
            x = x + self.attn.prefill(h, positions, causal=False)[0]
        else:
            x = x + self.attn.blocked(h, positions, causal=False)
        return x + self.mlp(L.apply_norm(norm, x, self.ln2))


class DecBlock(seq2seq.DecBlock):
    """``seq2seq.DecBlock`` with this module's attentions and MLP; called,
    it is ``seq2seq._dec_layer``'s training form on this rank's heads;
    with ``mode`` "prefill" its flash form, (x, this layer's cache: the
    rank's k and v, ``ek`` and ``ev`` of its kv heads and rows); with
    "decode" ``seq2seq.decode_step``'s layer ``layer``, which writes the
    rank's k and v block at ``pos`` in place and reads ``rows`` of the
    whole ``ek`` and ``ev``."""

    def __init__(self, cfg):
        super().__init__(cfg, "meta")
        self.cfg = cfg
        self.attn = Attention(cfg, "meta")
        self.xattn = Attention(cfg, "meta")
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, "meta")

    def forward(self, x: torch.Tensor, enc_x: Optional[torch.Tensor],
                positions: torch.Tensor, mode: str = "train", caches=None,
                layer: int = 0, pos: int = 0, rows: slice = slice(None),
                seq: bool = False):
        norm = self.cfg.norm
        h = L.apply_norm(norm, x, self.ln1)
        if mode == "decode":
            x = x + self.attn.decode(h, caches["k"][layer],
                                     caches["v"][layer], pos, positions, seq)
            x = x + self.xattn.cross_decode(
                L.apply_norm(norm, x, self.ln_x), caches["ek"][layer][rows],
                caches["ev"][layer][rows])
            return x + self.mlp(L.apply_norm(norm, x, self.ln2))
        cache = None
        if mode == "prefill":
            a, (k, v) = self.attn.prefill(h, positions)
        else:
            a = self.attn.blocked(h, positions)
        x = x + a
        ek, ev = self.xattn.enc_kv(enc_x)
        x = x + self.xattn.cross(L.apply_norm(norm, x, self.ln_x), ek, ev,
                                 flash=mode == "prefill")
        x = x + self.mlp(L.apply_norm(norm, x, self.ln2))
        if mode == "prefill":
            cache = {"k": k, "v": v, "ek": ek, "ev": ev}
            return x, cache
        return x


def _vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         lo: int, group) -> torch.Tensor:
    """``lm.cross_entropy`` of logits split over ``group`` by vocabulary
    (this rank's from ``lo``): the row max all-reduced (MAX), then the
    sum of exponentials and the label's logit (zero on the ranks that do
    not hold it) summed in one all-reduce."""
    import torch.distributed as dist
    logits = logits.float()
    mx = logits.detach().amax(-1)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    inside = (labels >= lo) & (labels < lo + logits.shape[-1])
    ll = torch.gather(logits, -1, torch.where(inside, labels - lo, 0)
                      .long()[..., None])[..., 0]
    se, ll = api.row_output(torch.stack([
        torch.exp(logits - mx[..., None]).sum(-1),
        torch.where(inside, ll, 0.0)]), group)
    return (torch.log(se) + mx - ll).mean()


class _Sharded:
    """One rank's share of a model on a mesh that holds a DeviceMesh
    (module docstring), built by :func:`build`: what :class:`ShardedLM`
    and :class:`ShardedEncDec` share. A subclass builds its model's
    modules on ``meta`` with this module's layers, then calls
    :meth:`_shard`; its parameters keep the plain model's names and
    order, and ``forward(batch)`` is the training loss of this rank's
    rows."""

    def _shard(self, mesh: Mesh, device) -> None:
        """Plan this rank's computation, then give every parameter its
        block's shape on ``device``, uninitialised."""
        self.place = place = Place(mesh)
        self.spec = specs(self, mesh)
        self._plan_vocab(place)
        self._plan(place)
        names, hand = self._names, set(self.by_hand())
        for mod in self.modules():
            for leaf, p in list(mod.named_parameters(recurse=False)):
                n = names[id(p)]
                shape = cut(p, self.spec[n], mesh, place.at, only=(
                    "model", "data") if n in hand else ("model",)).shape
                setattr(mod, leaf, L.new_param(*shape, dtype=p.dtype,
                                               device=device))

    @property
    def _names(self) -> Dict[int, str]:
        return {id(p): n for n, p in self.named_parameters()}

    def _model_block(self, name: str, dim: int):
        """This rank's stored block of dimension ``dim`` of ``name``
        (None: stored whole), from its spec."""
        spec = self.spec[name]
        if dim >= len(spec) or "model" not in _axes(spec[dim]):
            return None
        n = self.get_parameter(name).shape[dim] // self.place.m
        r = self.place.at["model"]
        return r * n, (r + 1) * n

    def _views(self, pre: str, need: Dict[str, Tuple], partial: bool
               ) -> Dict[str, View]:
        """The :class:`View` of each weight ``pre + name`` whose stored
        block is not what the rank computes with, ``need[name]`` = (dim,
        (lo, hi), size of the dim), or whose gradient the ranks sum
        (``partial``) over a whole replicated tensor."""
        views = {}
        for name, (dim, want, size) in need.items():
            stored = self._model_block(pre + name, dim)
            if stored == want or (stored is None and want == (0, size)
                                  and not partial):
                continue
            views[name] = View(dim, size, stored, want, partial)
        return views

    def _plan_vocab(self, place: Place) -> None:
        m, V = place.m, self.cfg.vocab
        self.vocab_group = place.model if m > 1 and V % m == 0 else None
        self.vocab_lo = place.at["model"] * V // m \
            if self.vocab_group is not None else 0

    def _plan_mlp(self, mlp: MLP, pre: str) -> None:
        mlp.group = self.place.model \
            if self._model_block(pre + "w1", 1) else None

    def _plan_attention(self, attn: Attention, pre: str, place: Place):
        cfg, m, r = self.cfg, place.m, place.at["model"]
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        split = m > 1 and Hq % m == 0
        if split:
            q = (r * Hq // m, (r + 1) * Hq // m)
            rep = Hq // Hkv
            kv = (q[0] // rep, (q[1] - 1) // rep + 1)
        else:
            q, kv = (0, Hq), (0, Hkv)
        attn.hq, attn.hkv = q[1] - q[0], kv[1] - kv[0]
        attn.kv = kv
        attn.group = place.model if split else None
        attn.model_group = place.model
        attn.data = (place.group.get("data"), place.at.get("data", 0))
        need = {"wq": (1, q, Hq), "wk": (1, kv, Hkv), "wv": (1, kv, Hkv),
                "wo": (0, q, Hq)}
        if cfg.qkv_bias:
            need.update(bq=(0, q, Hq), bk=(0, kv, Hkv), bv=(0, kv, Hkv))
        attn.views = self._views(pre, {
            n: (dim, (lo * hd, hi * hd), H * hd)
            for n, (dim, (lo, hi), H) in need.items()}, split)

    def _plan_cache(self, attn: Attention, pre: str, place: Place) -> None:
        """The rank's block of this layer's kv cache, as
        ``sharding.cache_spec_for_leaf`` puts the heads or ``head_dim``
        over "model": its kv heads (those it attends with), or columns
        ``attn.cols`` of every kv head, with the views that gather wq, wk,
        wv and wo whole (``attn.whole``)."""
        cfg, m, r = self.cfg, place.m, place.at["model"]
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        spec = cache_spec_for_leaf("k", (place.mesh.batch_shards, 1, Hkv,
                                         hd), place.mesh)
        heads, cols = (tuple(spec) + (None,) * 4)[2:4]
        if heads is not None:
            return
        if cols is None:
            raise ValueError(f"{cfg.name}: neither {Hkv} kv heads nor "
                             f"head_dim {hd} divide over {m}: no cache "
                             "block for the sharded serving step")
        attn.cols = (r * hd // m, (r + 1) * hd // m)
        need = {"wq": (1, Hq), "wk": (1, Hkv), "wv": (1, Hkv),
                "wo": (0, Hq)}
        attn.whole = self._views(pre, {
            n: (dim, (0, H * hd), H * hd) for n, (dim, H) in need.items()},
            False)

    def _plan_mamba(self, mb: Mamba, pre: str, place: Place) -> None:
        cfg, m, r = self.cfg, place.m, place.at["model"]
        H, G, P = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_head_dim
        d_in, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        split = m > 1 and H % m == 0
        h = (r * H // m, (r + 1) * H // m) if split else (0, H)
        rep = H // G
        mb.plan(h, (h[0] // rep, (h[1] - 1) // rep + 1))
        mb.group = place.model if split else None
        mb.model_group = place.model
        C, n_in = d_in + 2 * GN, 2 * d_in + 2 * GN + H
        n = place.mesh.batch_shards
        ssm = cache_spec_for_leaf("ssm", (n, H, P, cfg.ssm_state),
                                  place.mesh)
        if (m > 1 and "model" in _axes((tuple(ssm) + (None,) * 2)[1])) \
                != split:
            raise ValueError(f"{cfg.name}: the ssm cache's spec {ssm} and "
                             f"the split of {H} SSM heads over {m} disagree")
        conv = cache_spec_for_leaf("conv", (n, cfg.ssm_conv - 1, C),
                                   place.mesh)
        mb.conv_split = m > 1 and "model" in _axes(
            (tuple(conv) + (None,) * 3)[2])
        if mb.conv_split:
            mb.conv_block = (r * C // m, (r + 1) * C // m)
        rows = (h[0] * P, h[1] * P)
        mb.views = self._views(pre, {
            "in_proj": (1, (0, n_in), n_in), "conv_w": (0, (0, C), C),
            "conv_b": (0, (0, C), C), "dt_bias": (0, h, H),
            "A_log": (0, h, H), "D": (0, h, H), "norm_w": (0, rows, d_in),
            "out_proj": (0, rows, d_in)}, split)

    def _embed(self, tokens: torch.Tensor, patches=None) -> torch.Tensor:
        g = self.vocab_group
        if g is None:
            return lm._embed(self, tokens, patches)
        lo, n = self.vocab_lo, self.emb.shape[0]
        inside = (tokens >= lo) & (tokens < lo + n)
        x = F.embedding(torch.where(inside, tokens - lo, 0), self.emb) \
            * inside[..., None].to(self.emb.dtype)
        x = api.row_output(x, g).to(torch.bfloat16)
        nv = self.cfg.n_vision_tokens
        if nv and patches is not None:
            x[:, :nv] += patches.to(torch.bfloat16) @ self.vis_proj
        return x

    def _cross_entropy(self, h: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
        """``lm.cross_entropy`` of the logits ``h @ head``, split by
        vocabulary over the model group where it divides."""
        g = self.vocab_group
        if g is None:
            return lm.cross_entropy(h @ self.head(), labels)
        return _vocab_cross_entropy(api.column_input(h, g) @ self.head(),
                                    labels, self.vocab_lo, g)

    # -- serving: the sharded prefill and decode steps --

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm of x (B, 1, D) times the rank's block of the
        head: its vocabulary block of the logits where the vocabulary
        divides over "model", else all of them."""
        return L.apply_norm(self.cfg.norm, x, self.ln_f) @ self.head()

    def _layout(self, specs: Optional[Dict[str, tuple]]
                ) -> Tuple[bool, bool]:
        """(the rows whole on every batch rank, the kv cache's sequence
        split over "data") of a decode step whose whole cache has the
        specs ``specs`` (``sharding.cache_specs``); None: rows split over
        the batch axes, as a prefill's."""
        if specs is None:
            return False, False

        def entry(name, i):
            spec = tuple(specs.get(name, ())) + (None,) * 5
            return _axes(spec[i])
        first = next(n for n in ("k", "conv") if n in specs)
        whole = self.place.mesh.batch_shards > 1 and not entry(first, 1)
        seq = "data" in entry("k", 2) and \
            self.place.group.get("data") is not None
        return whole, seq

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None):
        """``model.prefill_fn`` of this rank's rows (``tokens`` (B, S), a
        vision arch's ``patches``, an encoder-decoder's ``frames``; rows
        split over the batch axes, :func:`rank_rows`), forward only: (the
        rank's block of the last position's logits (B, 1, V or V /
        model), its block of the cache with k and v of ``cache_len``
        (default S) positions, as ``sharding.cache_specs`` gives it).
        Attention runs the flash kernel; at world 1 on (1, 1) this is
        ``prefill_fn`` bit for bit."""
        out = self(batch, "prefill", cache_len=cache_len)
        self.reshard()
        return out

    @torch.no_grad()
    def decode_step(self, caches: lm.Cache, token: torch.Tensor, pos: int,
                    specs: Optional[Dict[str, tuple]] = None):
        """``model.decode_fn`` of this rank's rows: token (B, 1), one
        position ``pos`` for every row (R6), ``caches`` the rank's block
        (:meth:`prefill`), advanced in place; (the rank's block of the
        logits (B, 1, V or V / model), caches). ``specs``: the whole
        cache's ``sharding.cache_specs``, which say where the rows are
        whole and the sequence lies over "data" (a B = 1 decode); None:
        rows split, as :meth:`prefill` leaves them. Never gathers a k or
        v cache."""
        out = self({"token": token}, "decode", caches, pos, specs=specs)
        self.reshard()
        return out

    # -- the state as one rank holds it --

    def local_params(self) -> Dict[str, torch.Tensor]:
        """This rank's shard of each parameter (a DTensor's local tensor:
        in-place updates reach FSDP's storage), by name."""
        return {n: _local(p) for n, p in self.named_parameters()}

    def replicated(self) -> List[str]:
        """The parameters whose spec names no "data": whole over the
        batch ranks."""
        return [n for n, s in self.spec.items()
                if not any("data" in _axes(e) for e in s)]

    def by_hand(self) -> List[str]:
        """The sharded parameters that FSDP cannot hold, each an MoE's
        float32 router in a unit of bf16 weights (:class:`_DataGather`)."""
        return [n for n, s in self.spec.items() if n.endswith("moe.router")
                and any("data" in _axes(e) for e in s)]

    def local_grads(self) -> Dict[str, torch.Tensor]:
        """This rank's shard of each gradient, in parameter order (zeros
        for an unused parameter): FSDP's reduce-scattered mean for the
        sharded ones, the batch ranks' f32 mean for the replicated ones
        (one all-reduce a batch axis)."""
        grads = {n: torch.zeros_like(_local(p)) if p.grad is None
                 else _local(p.grad) for n, p in self.named_parameters()}
        groups = self.place.batch
        if groups:
            import torch.distributed as dist
            names = self.replicated()
            flat = torch.cat([grads[n].float().reshape(-1) for n in names])
            for g in groups:
                dist.all_reduce(flat, group=g)
            flat /= math.prod(dist.get_world_size(g) for g in groups)
            for n, piece in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                grads[n] = piece.view(grads[n].shape).to(grads[n].dtype)
        return grads

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``adamw.global_norm`` of the whole gradients from this rank's
        shards: each leaf's f32 sum of squares summed over the axes that
        split it (one all-reduce a set of axes), then over the leaves in
        order."""
        import torch.distributed as dist
        sq = {n: torch.sum(g.float() ** 2) for n, g in grads.items()}
        by_axes: Dict[Tuple, List[str]] = {}
        for n, s in self.spec.items():
            axes = tuple(a for a in ("data", "model")
                         if any(a in _axes(e) for e in s)
                         and self.place.group.get(a) is not None)
            by_axes.setdefault(axes, []).append(n)
        for axes, names in by_axes.items():
            if not axes:
                continue
            v = torch.stack([sq[n] for n in names])
            for a in axes:
                dist.all_reduce(v, group=self.place.group[a])
            sq.update(zip(names, v.unbind()))
        return torch.sqrt(sum(sq[n] for n in grads))

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the batch ranks (itself without any)."""
        import torch.distributed as dist
        if not self.place.batch:
            return t
        t = t.clone()
        for g in self.place.batch:
            dist.all_reduce(t, group=g)
        return t / math.prod(dist.get_world_size(g) for g in self.place.batch)


class ShardedLM(_Sharded, lm.DecoderLM):
    """One rank's share of a decoder-only LM (dense, MoE, SSM or hybrid):
    ``lm.DecoderLM``'s parameters under their names and order;
    ``forward(batch)`` is ``lm.loss_fn`` of this rank's rows."""

    def __init__(self, cfg, mesh: Mesh, device):
        if cfg.family not in FAMILIES or cfg.family == "encdec":
            raise ValueError(f"{cfg.name} ({cfg.family}) is not a "
                             "decoder-only LM of the sharded step")
        super().__init__(cfg, "meta")
        self.blocks = nn.ModuleList(Block(cfg, mx, f) for mx, f in self.kinds)
        self._shard(mesh, device)

    def layers(self) -> List[nn.Module]:
        return list(self.blocks)

    def _plan(self, place: Place) -> None:
        cfg, m, r = self.cfg, place.m, place.at["model"]
        for i, blk in enumerate(self.blocks):
            pre = f"blocks.{i}."
            if blk.mixer == "attn":
                self._plan_attention(blk.attn, pre + "attn.", place)
                self._plan_cache(blk.attn, pre + "attn.", place)
            else:
                self._plan_mamba(blk.mamba, pre + "mamba.", place)
            if blk.ffn == "mlp":
                self._plan_mlp(blk.mlp, pre + "mlp.")
            elif blk.ffn == "moe":
                E, Fs = cfg.n_experts, cfg.moe_d_ff * cfg.n_shared_experts
                if m > 1 and (E % m or Fs % m):
                    raise ValueError(f"{cfg.name}: {E} experts and shared "
                                     f"width {Fs} must divide over {m}")
                blk.first_expert = r * E // m
                blk.expert_group = place.model
                blk.batch_groups = place.batch
                if pre + "moe.router" in self.by_hand() and place.batch:
                    blk.router_gather = (0, place.group.get("data"),
                                         place.group.get("pod"))

    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "loss",
                caches: Optional[lm.Cache] = None, pos: int = 0,
                cache_len: Optional[int] = None, specs=None):
        """``lm.loss_fn`` of this rank's rows (aux weight 0.01); with
        ``mode`` "prefill" or "decode", :meth:`prefill`'s or
        :meth:`decode_step`'s work (called through the module, so that
        FSDP gathers the root's parameters)."""
        if mode == "prefill":
            return self._prefill(batch, cache_len)
        if mode == "decode":
            return self._decode(batch["token"], caches, pos,
                                self._layout(specs))
        tokens = batch["tokens"]
        x = self._embed(tokens, batch.get("patches"))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, aux = lm.run_blocks(self, x, positions)
        h = L.apply_norm(self.cfg.norm, x, self.ln_f)
        return self._cross_entropy(h, batch["labels"]) + AUX_WEIGHT * aux

    def _prefill(self, batch, cache_len):
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens, batch.get("patches"))
        positions = torch.arange(S, device=tokens.device)
        n = {m: sum(k == m for k, _ in self.kinds) for m in ("attn", "mamba")}
        caches: lm.Cache = {}
        for blk, row in zip(self.blocks, self.rows):
            x, c = blk(x, positions, "prefill")
            for name, t in c.items():
                if name not in caches:
                    long = (cache_len or S,) if name in ("k", "v") \
                        else t.shape[1:2]
                    caches[name] = t.new_zeros((n[blk.mixer], B) + long
                                               + t.shape[2:])
                caches[name][row, :, :t.shape[1]] = t
        return self._logits(x[:, -1:, :]), caches

    def _decode(self, token: torch.Tensor, caches: lm.Cache, pos: int,
                layout: Tuple[bool, bool]):
        x = self._embed(token)
        positions = torch.tensor([pos], device=token.device)
        for blk, row in zip(self.blocks, self.rows):
            x = blk(x, positions, "decode", caches, row, pos, layout)
        return self._logits(x), caches


class ShardedEncDec(_Sharded, seq2seq.EncDecLM):
    """One rank's share of an encoder-decoder: ``seq2seq.EncDecLM``'s
    parameters under their names and order; ``forward(batch)`` is
    ``seq2seq.loss_fn`` of this rank's rows (``frames``, ``tokens``,
    ``labels``), each layer of both stacks checkpointed with
    ``cfg.remat``."""

    def __init__(self, cfg, mesh: Mesh, device):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name} ({cfg.family}) is not an "
                             "encoder-decoder")
        super().__init__(cfg, "meta")
        self.enc_blocks = nn.ModuleList(EncBlock(cfg)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg)
                                        for _ in range(cfg.dec_layers))
        self._shard(mesh, device)

    def head(self) -> torch.Tensor:
        return self.lm_head

    def layers(self) -> List[nn.Module]:
        return list(self.enc_blocks) + list(self.dec_blocks)

    def _plan(self, place: Place) -> None:
        for stack, blocks in (("enc_blocks", self.enc_blocks),
                              ("dec_blocks", self.dec_blocks)):
            for i, blk in enumerate(blocks):
                pre = f"{stack}.{i}."
                self._plan_attention(blk.attn, pre + "attn.", place)
                if stack == "dec_blocks":
                    self._plan_attention(blk.xattn, pre + "xattn.", place)
                self._plan_mlp(blk.mlp, pre + "mlp.")

    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "loss",
                caches: Optional[lm.Cache] = None, pos: int = 0,
                cache_len: Optional[int] = None, specs=None):
        """``seq2seq.loss_fn`` of this rank's rows; with ``mode`` "prefill"
        or "decode", :meth:`prefill`'s or :meth:`decode_step`'s work."""
        if mode == "prefill":
            return self._prefill(batch, cache_len)
        if mode == "decode":
            return self._decode(batch["token"], caches, pos,
                                self._layout(specs))
        cfg = self.cfg

        def layer(blk, *args):
            if cfg.remat:
                return checkpoint(blk, *args, use_reentrant=False)
            return blk(*args)
        x = batch["frames"].to(torch.bfloat16)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.enc_blocks:
            x = layer(blk, x, positions)
        enc_x = L.apply_norm(cfg.norm, x, self.enc_ln_f)
        tokens = batch["tokens"]
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for blk in self.dec_blocks:
            x = layer(blk, x, enc_x, positions)
        h = L.apply_norm(cfg.norm, x, self.ln_f)
        return self._cross_entropy(h, batch["labels"])

    # -- serving: seq2seq.prefill and decode_step on this rank's share --

    def _serves(self) -> None:
        m, Hkv = self.place.m, self.cfg.n_kv_heads
        if m > 1 and Hkv % m:
            raise ValueError(
                f"{self.cfg.name}: {Hkv} kv heads do not divide over {m}: "
                "an encoder-decoder's serving step keeps a block of kv "
                "heads (its cache holds no head_dim columns)")

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """The encoder's k or v of this rank's rows and kv heads (B, S_enc,
        hkv, hd) gathered over the model heads, then the batch rows
        (data, then pod): every rank holds ``ek`` and ``ev`` whole."""
        if self.dec_blocks[0].xattn.group is not None:
            t = _gather(t, 2, self.place.model)
        for g in reversed(self.place.batch):
            t = _gather(t, 0, g)
        return t

    def _prefill(self, batch, cache_len):
        self._serves()
        cfg = self.cfg
        x = batch["frames"].to(torch.bfloat16)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.enc_blocks:
            x = blk(x, positions, "prefill")
        enc_x = L.apply_norm(cfg.norm, x, self.enc_ln_f)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = self._embed(tokens)
        positions = torch.arange(S, device=tokens.device)
        caches: lm.Cache = {}
        for i, blk in enumerate(self.dec_blocks):
            x, c = blk(x, enc_x, positions, "prefill")
            c["ek"], c["ev"] = self._whole(c["ek"]), self._whole(c["ev"])
            for name, t in c.items():
                if name not in caches:
                    long = (cache_len or S,) if name in ("k", "v") \
                        else t.shape[1:2]
                    caches[name] = t.new_zeros(
                        (len(self.dec_blocks), t.shape[0]) + long
                        + t.shape[2:])
                caches[name][i, :, :t.shape[1]] = t
        return self._logits(x[:, -1:, :]), caches

    def _decode(self, token: torch.Tensor, caches: lm.Cache, pos: int,
                layout: Tuple[bool, bool]):
        self._serves()
        whole, seq = layout
        x = self._embed(token)
        positions = torch.tensor([pos], device=token.device)
        b, g = token.shape[0], self.place.batch_shard
        rows = slice(None) if whole else slice(g * b, (g + 1) * b)
        for i, blk in enumerate(self.dec_blocks):
            x = blk(x, None, positions, "decode", caches, i, pos, rows, seq)
        return self._logits(x), caches


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def build(cfg, mesh: Mesh, device=None,
          state: Optional[Dict[str, torch.Tensor]] = None) -> _Sharded:
    """This rank's :class:`ShardedLM` or :class:`ShardedEncDec` of
    ``cfg`` on ``mesh`` (``device``: None = CUDA), its parameters
    requiring grad and sharded by ``fully_shard`` (one unit a layer,
    then the root); loaded from ``state`` (this rank's
    :func:`shard_state`) if given, else left uninitialised (the dry
    run's fake tensors)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    cls = ShardedEncDec if cfg.family == "encdec" else ShardedLM
    model = cls(cfg, mesh, resolve_device(device))
    model.requires_grad_(True)
    names = model._names
    ignored = {model.get_parameter(n)
               for n in model.replicated() + model.by_hand()}

    def placement(p):
        spec = model.spec[names[id(p)]]
        return Shard(next(i for i, e in enumerate(spec) if "data" in _axes(e)))
    dm = model.place.fsdp_mesh()
    for layer in model.layers():
        fully_shard(layer, mesh=dm, shard_placement_fn=placement,
                    ignored_params=ignored)
    fully_shard(model, mesh=dm, shard_placement_fn=placement,
                ignored_params=ignored)
    if state is not None:
        with torch.no_grad():
            for n, p in model.local_params().items():
                if p.shape != state[n].shape:
                    raise ValueError(f"{n}: shard {tuple(state[n].shape)} "
                                     f"for a rank that holds {tuple(p.shape)}")
                p.copy_(state[n])
    return model


def make_step(opt_cfg: adamw.OptConfig):
    """``train_step(model, opt_state, batch) -> {"loss", "lr",
    "grad_norm"}`` of a model from :func:`build`: the loss of this rank's
    rows (``batch``: :func:`rank_rows`), its backward (FSDP's gathers and
    reduce-scatters, the model group's collectives), the gradients'
    shards (``local_grads``) and their whole norm, and one AdamW update
    of this rank's shards and ``opt_state`` (``adamw.init`` of
    ``model.local_params()``) in place. The loss is averaged over the
    batch ranks."""
    def train_step(model: _Sharded, opt_state, batch):
        loss = model(batch)
        loss.backward()
        grads = model.local_grads()
        gnorm = model.grad_norm(grads)
        _, _, stats = adamw.update(opt_cfg, grads, opt_state,
                                   model.local_params(), grad_norm=gnorm)
        model.zero_grad(set_to_none=True)
        return {"loss": model.batch_mean(loss.detach()), **stats}
    return train_step


# --- the record of collectives -----------------------------------------------


_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class Recorder(TorchDispatchMode):
    """Logs every c10d collective dispatched while it is active, as (kind,
    result bytes, group size): the kind in HLO's words, the bytes of its
    output (for an all-reduce its tensors), the size of its process
    group. Any other c10d collective raises: nothing goes unrecorded."""

    def __init__(self):
        super().__init__()
        self.log: List[Tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            from torch._C._distributed_c10d import ProcessGroup
            name = func.__name__.split(".")[0]
            kind = next((k for key, k in _KINDS if key in name), None)
            if kind is None:
                raise RuntimeError(f"unrecorded collective {func}")
            names = [a.name for a in func._schema.arguments]
            group = args[names.index("process_group")]
            self.log.append((kind, _nbytes(args[0]),
                             ProcessGroup.unbox(group).size()))
        return func(*args, **kwargs)
