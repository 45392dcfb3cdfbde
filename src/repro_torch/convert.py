"""Carry fabrics and routed tables into the port as plain arrays.

The system has no weights: what crosses over is the fabric and its
simulator tables. Both enter as numpy arrays, so nothing here needs the
JAX package -- the synthesized fabrics in ``benchmarks/results/*.pkl``
are plain dicts with an ``optical`` list, and a reference ``SimTables``
converts through :func:`sim_tables_from_arrays` with a dict of its
fields.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netsim import SimTables
from repro_torch.core.pathtable import CSRPathTable
from repro_torch.core.topology import Pod, Topology

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
