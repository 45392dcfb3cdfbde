"""One-call cold-build routing pipeline (facade over the staged API).

The cold-build chain ``Channels.from_topology -> allowed_turns ->
select_paths -> allocate_vcs -> build_tables`` used to be copy-pasted
across synthesis evaluation, the serving-state builder, the fault sweep,
four benchmarks and the examples, each with its own kwarg tunnel.
:func:`route_pod` runs the same stages off one :class:`PipelineConfig`
and returns a :class:`RoutedPod` carrying every intermediate the call
sites used to re-derive (allowed turns, routing result, VC counts,
simulator tables, per-stage wall-clock). This module adds no routing
semantics of its own -- the staged functions stay the extension
surface -- and a migrated call site produces bit-identical tables for
the same config and seed (tests/test_pipeline.py proves it against the
raw chain).

Three VC modes cover every internal consumer:

- ``vc="tables"`` (default): :func:`repro.core.netsim.at_tables`
  semantics -- allocate on a *copy* of the routed table and return
  simulator-ready :class:`~repro.core.netsim.SimTables` (synthesis
  evaluation, benchmarks, examples).
- ``vc="inplace"``: :func:`repro.core.vcalloc.allocate_vcs` directly on
  ``routed.table`` (no copy, no SimTables) -- the serving-state cold
  build, where the live table and the VC counts must be the same
  object the repair path later patches.
- ``vc="none"``: selection only -- fault sweeps and ablations that
  score ``l_max`` without ever simulating.

Port of ``repro.core.pipeline``: the same stages and config, plus the
``device`` on which the all-pairs hop matrix is computed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Union

import numpy as np

from repro_torch.core.routing import (ATResult, RoutingResult,
                                      allowed_turns, select_paths)
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device

_VC_MODES = ("tables", "inplace", "none")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Every knob of the cold-build chain in one place.

    Field groups mirror the stages: admission (``n_vc``/``priority``/
    ``robust``/``at_engine``), selection (``K``/``seed``/``engine``/
    ``local_search_rounds``/``shard_sources``/``rounds``/``k_min``/
    ``refine_cap``/``uniq_dp``/``block``), VC allocation (``vc``/
    ``balance``/``reserve_escape``) and verification (``verify``).
    Defaults match the repo-wide common case (sharded selection at
    K=4, balanced VC allocation into simulator tables).
    """
    # ---- allowed-turn admission ----
    n_vc: int = 2
    priority: str = "apl"
    robust: bool = False
    at_engine: str = "batched"
    # ---- path selection ----
    K: int = 4
    seed: int = 0
    engine: str = "sharded"
    local_search_rounds: int = 2
    block: Optional[int] = None
    shard_sources: int = 64
    rounds: int = 4
    k_min: Optional[int] = None
    refine_cap: Optional[int] = None
    uniq_dp: Union[str, bool] = "auto"
    # ---- VC allocation / tables ----
    vc: str = "tables"                  # "tables" | "inplace" | "none"
    balance: Optional[bool] = True      # None skips re-allocation
    reserve_escape: bool = False
    # ---- verification ----
    verify: bool = False

    def __post_init__(self):
        if self.vc not in _VC_MODES:
            raise ValueError(f"vc mode must be one of {_VC_MODES}, "
                             f"got {self.vc!r}")


@dataclasses.dataclass
class RoutedPod:
    """Everything the cold-build chain produced, in one object."""
    topo: Topology
    cfg: PipelineConfig
    at: ATResult
    routed: RoutingResult
    tables: Optional[Any] = None          # SimTables (vc="tables")
    vc_counts: Optional[np.ndarray] = None  # (n_vc,) (vc="inplace")
    vc_stats: Optional[dict] = None
    deadlock_free: Optional[bool] = None  # set when cfg.verify
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def table(self):
        """The routed path table (allocated in place for vc="inplace";
        the SimTables carry their own allocated copy for vc="tables")."""
        return self.routed.table

    @property
    def l_max(self) -> float:
        return float(self.routed.l_max)

    @property
    def avg_hops(self) -> float:
        return float(self.routed.avg_hops)

    @property
    def unreachable(self) -> int:
        return int(self.routed.unreachable)


def route_pod(topo: Topology, cfg: Optional[PipelineConfig] = None, *,
              at: Optional[ATResult] = None,
              dead_channels=None, chosen_loads=None,
              pair_weight: Optional[np.ndarray] = None,
              dist_out: Optional[np.ndarray] = None,
              best_out: Optional[np.ndarray] = None,
              select_kw: Optional[dict] = None,
              device=None) -> RoutedPod:
    """Run the cold-build chain on ``topo`` under one config.

    ``at`` reuses a prebuilt allowed-turn set (fault sweeps re-route
    against the no-fault AT); ``dead_channels`` masks failed channels
    during selection; ``chosen_loads`` enables the CPL admission
    variant; ``pair_weight`` enables demand-weighted selection
    (``engine="array"`` only -- see
    :func:`~repro.core.routing.select_paths`);
    ``dist_out``/``best_out`` capture the sharded engine's BFS
    distance fields (the serving-state hooks); ``select_kw`` overrides
    individual :func:`~repro.core.routing.select_paths` kwargs on top
    of the config (escape hatch for staged experiments). ``device``
    (``None`` = CUDA, which raises when no GPU is present) is where the
    APL priority's all-pairs hop matrix is computed.
    """
    device = resolve_device(device)
    cfg = cfg or PipelineConfig()
    timings: Dict[str, float] = {}
    if at is None:
        t0 = time.time()
        at = allowed_turns(topo, n_vc=cfg.n_vc, priority=cfg.priority,
                           robust=cfg.robust, seed=cfg.seed,
                           chosen_loads=chosen_loads,
                           at_engine=cfg.at_engine, device=device)
        timings["at_s"] = time.time() - t0
    kw = dict(K=cfg.K, seed=cfg.seed, engine=cfg.engine,
              dead_channels=dead_channels,
              local_search_rounds=cfg.local_search_rounds,
              block=cfg.block, shard_sources=cfg.shard_sources,
              rounds=cfg.rounds, k_min=cfg.k_min,
              refine_cap=cfg.refine_cap, uniq_dp=cfg.uniq_dp,
              pair_weight=pair_weight,
              dist_out=dist_out, best_out=best_out)
    kw.update(select_kw or {})
    t0 = time.time()
    routed = select_paths(at, **kw)
    timings["select_s"] = time.time() - t0

    tables = None
    vc_counts = None
    vc_stats: dict = {}
    t0 = time.time()
    if cfg.vc == "tables":
        from repro_torch.core.netsim import at_tables
        tables = at_tables(topo, at, routed, balance=cfg.balance,
                           stats=vc_stats,
                           reserve_escape=cfg.reserve_escape)
    elif cfg.vc == "inplace":
        from repro_torch.core.vcalloc import allocate_vcs
        vc_counts = allocate_vcs(
            at, routed.table,
            balance=True if cfg.balance is None else cfg.balance,
            stats=vc_stats, reserve_escape=cfg.reserve_escape)
    timings["vc_s"] = time.time() - t0

    deadlock_free = None
    if cfg.verify:
        from repro_torch.core.vcalloc import verify_deadlock_free
        tbl = tables.table if tables is not None else routed.table
        deadlock_free = bool(verify_deadlock_free(at, tbl))
    return RoutedPod(topo, cfg, at, routed, tables=tables,
                     vc_counts=vc_counts, vc_stats=vc_stats,
                     deadlock_free=deadlock_free, timings=timings)
