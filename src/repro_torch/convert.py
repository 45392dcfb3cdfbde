"""Carry fabrics, routed tables and model weights into the port as plain
arrays.

Everything enters as numpy arrays, so nothing here needs the JAX
package: the synthesized fabrics in ``benchmarks/results/*.pkl`` are
plain dicts with an ``optical`` list, a reference ``SimTables`` converts
through :func:`sim_tables_from_arrays` with a dict of its fields, and a
JAX model's parameter tree converts through :func:`params_from_jax`
after ``np.asarray`` on each leaf, and its AdamW state through
:func:`opt_state_from_jax`.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.netsim import SimTables
from repro_torch.core.pathtable import CSRPathTable
from repro_torch.core.topology import Pod, Topology
from repro_torch.device import resolve_device
from repro_torch.models.lm import DecoderLM
from repro_torch.models.seq2seq import EncDecLM

SIM_TABLE_KEYS = ("n", "n_ch", "n_vc", "ch_dst", "src_indptr", "dst",
                  "hop_indptr", "chan", "vc")


def topology_from_arrays(dims: Tuple[int, int, int],
                         optical: Sequence[Sequence[int]],
                         name: Optional[str] = None) -> Topology:
    """The port's :class:`Topology` from pod dims and ``(u, v, color)``
    optical circuits."""
    opt = [tuple(int(x) for x in e) for e in optical]
    return Topology(Pod(tuple(int(d) for d in dims)), opt,
                    name=name or f"topo {tuple(dims)}")


def load_fabric(path, dims: Tuple[int, int, int],
                name: Optional[str] = None) -> Topology:
    """A synthesized fabric pickled as a dict with an ``optical`` list
    (``benchmarks/results/tons_*.pkl``). Only load files this repository
    wrote: unpickling runs code."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return topology_from_arrays(dims, d["optical"],
                                name=name or Path(path).stem)


def sim_tables_from_arrays(d: Mapping[str, object]) -> SimTables:
    """The port's :class:`SimTables` (CSR layout) from a dict holding
    ``n, n_ch, n_vc, ch_dst, src_indptr, dst, hop_indptr, chan, vc``."""
    missing = [k for k in SIM_TABLE_KEYS if k not in d]
    if missing:
        raise KeyError(f"sim table arrays lack {missing}")
    n, n_ch, n_vc = int(d["n"]), int(d["n_ch"]), int(d["n_vc"])
    table = CSRPathTable(
        n, n_ch, n_vc,
        np.asarray(d["src_indptr"], np.int64).copy(),
        np.asarray(d["dst"], np.int32).copy(),
        np.asarray(d["hop_indptr"], np.int64).copy(),
        np.asarray(d["chan"], np.int32).copy(),
        np.asarray(d["vc"], np.int8).copy())
    ch_dst = np.asarray(d["ch_dst"], np.int32).copy()
    if len(ch_dst) != n_ch:
        raise ValueError(f"ch_dst has {len(ch_dst)} entries, n_ch={n_ch}")
    return SimTables(n, n_ch, n_vc, ch_dst, table)


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values. bfloat16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) cross as
    their 16-bit patterns, so the conversion is bit-exact."""
    arr = np.array(arr, order="C")      # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves of a tree of dicts and lists under dotted names (a list's
    items by index)."""
    out = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _unstack(state: Dict[str, np.ndarray], arr: np.ndarray, top: str,
             leaf: str, first: int = 0, step: int = 1) -> None:
    """Layer ``j`` of a leaf stacked over a leading layer axis becomes
    ``{top}.{first + j * step}.{leaf}``."""
    for j in range(arr.shape[0]):
        state[f"{top}.{first + j * step}.{leaf}"] = arr[j]


def _load(model: torch.nn.Module, state: Mapping[str, np.ndarray]
          ) -> torch.nn.Module:
    """Copy ``state`` into ``model``'s parameters, bit for bit. Raises on
    a missing, extra or misshapen leaf, or one of another dtype."""
    want = dict(model.named_parameters())
    if set(state) != set(want):
        raise KeyError(f"parameter trees differ: missing "
                       f"{sorted(set(want) - set(state))}, extra "
                       f"{sorted(set(state) - set(want))}")
    for name, p in want.items():
        t = tensor_from_numpy(state[name])
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"the port holds {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


def module_params_from_jax(module: torch.nn.Module, tree: Mapping
                           ) -> torch.nn.Module:
    """Copy a reference sub-tree of one layer (an attention, MLP, MoE or
    Mamba tree, leaves as numpy arrays) into the port module that holds
    the same leaves."""
    return _load(module, _flatten(tree))


def params_from_jax(cfg, params: Mapping, device=None):
    """The port's model holding the weights of a reference parameter tree
    of any family, leaves as numpy arrays: a :class:`DecoderLM` for the
    dense, MoE, SSM and hybrid families (``repro.models.lm.init_params``
    layout), an :class:`EncDecLM` for the encoder-decoder
    (``repro.models.seq2seq.init_params``). Raises on a missing, extra or
    misshapen leaf."""
    device = resolve_device(device)
    model = EncDecLM if cfg.family == "encdec" else DecoderLM
    return _load(model(cfg, device), _state(cfg, params))


def _state(cfg, tree: Mapping) -> Dict[str, np.ndarray]:
    """A reference parameter-shaped tree's leaves under the port's names."""
    return _seq2seq_state(tree) if cfg.family == "encdec" \
        else _lm_state(cfg, tree)


def opt_state_from_jax(model: torch.nn.Module, opt_state: Mapping) -> Dict:
    """The reference's AdamW state (``repro.optim.adamw.init``'s ``{"m",
    "v", "step"}``, leaves as numpy arrays) for the port's ``model``: the
    moments mapped onto its parameter names as :func:`params_from_jax`
    maps the weights, as float32 tensors on the model's device, and the
    step as an int32 0-dim tensor (``repro_torch.optim.adamw``'s
    layout). Raises on a missing, extra or misshapen leaf."""
    want = dict(model.named_parameters())
    dev = next(iter(want.values())).device
    out = {}
    for key in ("m", "v"):
        flat = _state(model.cfg, opt_state[key])
        if set(flat) != set(want):
            raise KeyError(f"opt_state[{key!r}] differs from the model: "
                           f"missing {sorted(set(want) - set(flat))}, extra "
                           f"{sorted(set(flat) - set(want))}")
        out[key] = {}
        for name, p in want.items():
            t = tensor_from_numpy(flat[name])
            if t.shape != p.shape or t.dtype != torch.float32:
                raise ValueError(f"{key}.{name}: got {tuple(t.shape)} "
                                 f"{t.dtype}, want {tuple(p.shape)} float32")
            out[key][name] = t.to(dev)
    out["step"] = torch.tensor(int(np.asarray(opt_state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def _lm_state(cfg, params: Mapping) -> Dict[str, np.ndarray]:
    """An LM tree's leaves under the port's names. The reference's layers
    go to ``blocks.{i}`` in absolute order: its ``head_blocks[i]`` to
    ``i``, its stacked ``blocks`` layer ``j`` to ``first_k_dense + j``,
    and a hybrid's ``blocks.sub{s}`` layer ``j`` to
    ``j * hybrid_period + s``."""
    state = {}
    for name, arr in _flatten(params).items():
        top, _, rest = name.partition(".")
        if top == "head_blocks":
            state[f"blocks.{rest}"] = arr
        elif top == "blocks" and cfg.family == "hybrid":
            sub, _, leaf = rest.partition(".")
            if not sub.startswith("sub"):
                raise KeyError(f"hybrid layer leaf {name} is not under "
                               "blocks.sub{s}")
            _unstack(state, arr, top, leaf, int(sub[3:]), cfg.hybrid_period)
        elif top == "blocks":
            _unstack(state, arr, top, rest, cfg.first_k_dense)
        else:
            state[name] = arr
    return state


def _seq2seq_state(params: Mapping) -> Dict[str, np.ndarray]:
    """An encoder-decoder tree's leaves under the port's names: its
    stacked ``enc_blocks`` and ``dec_blocks`` go to ``enc_blocks.{i}``
    and ``dec_blocks.{i}``."""
    state = {}
    for name, arr in _flatten(params).items():
        top, _, rest = name.partition(".")
        if top in ("enc_blocks", "dec_blocks"):
            _unstack(state, arr, top, rest)
        else:
            state[name] = arr
    return state
