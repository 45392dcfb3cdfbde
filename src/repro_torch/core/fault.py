"""OCS fault tolerance (paper Section 5.2 / Appendix D).

Port of ``repro.core.fault``: host code, unchanged except that
:func:`fault_sweep` passes ``device`` to
:func:`~repro_torch.core.pipeline.route_pod`.

Fault model: one OCS (color) fails at a time, disabling every optical link
routed through it; the fault is known before job launch and fault-specific
routing tables are loaded (Google WFR-style, but re-solved through the AT
candidate set). C8 (lambda >= (f+1)/(32 n)) certifies f+1 OCS-disjoint
spanning trees via Nash-Williams, so connectivity survives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import PipelineConfig, route_pod
from repro_torch.core.repair import RepairResult, ServingState, repair_fault
from repro_torch.core.routing import ATResult, RoutingResult, allowed_turns
from repro_torch.core.topology import N_COLORS, Topology


def colors_in_use(topo: Topology) -> List[int]:
    col = topo.edge_colors()
    return np.unique(col[col >= 0]).astype(np.int64).tolist()


def dead_channels_for_color(at: ATResult, color: int) -> np.ndarray:
    """Channel ids of every optical link through OCS ``color``, as a
    sorted int64 array (the form the routing/repair hot paths consume
    directly -- no python sets on the per-fault path). The channels-by-
    color grouping is built once per :class:`Channels` and cached, so a
    sweep over all colors pays one argsort total."""
    ch = at.channels
    cache = ch.__dict__.get("_color_csr")
    if cache is None:
        order = np.argsort(ch.color, kind="stable").astype(np.int64)
        vals = ch.color[order]
        ucol, starts = np.unique(vals, return_index=True)
        cache = (order, ucol, np.append(starts, len(vals)))
        ch.__dict__["_color_csr"] = cache
    order, ucol, starts = cache
    i = int(np.searchsorted(ucol, color))
    if i >= len(ucol) or ucol[i] != color:
        return np.zeros(0, np.int64)
    return np.sort(order[starts[i]:starts[i + 1]])


def fault_region_nodes(at: ATResult, color: int) -> np.ndarray:
    """Nodes incident to the failed OCS's links -- the impaired region
    that fault-correlated recovery traffic clusters around
    (:meth:`repro_torch.core.traffic.TrafficPattern.fault_correlated`)."""
    ch = at.channels
    dead = ch.color == color
    return np.unique(np.concatenate([ch.src[dead], ch.dst[dead]]))


def fault_event(at: ATResult, color: int,
                t: int) -> Tuple[int, np.ndarray]:
    """A mid-sweep OCS failure as the ``fault=(t, dead_channels)`` pair
    :func:`repro_torch.core.netsim.sweep` consumes: OCS ``color`` dies at
    cycle ``t``, killing every optical link routed through it. ``t``
    must be non-negative (range against the sweep's cycle budget is
    checked by the simulator, which knows it)."""
    if t < 0:
        raise ValueError(f"fault cycle must be >= 0, got {t}")
    return int(t), dead_channels_for_color(at, color)


def fault_tolerance_certificate(topo: Topology, lam: float, f: int = 1
                                ) -> Dict[str, float]:
    """Appendix D: t_max <= min(floor(32 n lambda), 48)."""
    n = topo.n
    by_throughput = int(np.floor(32 * n * lam))
    return {
        "throughput_implied_trees": by_throughput,
        "color_budget": N_COLORS,
        "t_max": min(by_throughput, N_COLORS),
        "certified_f": min(by_throughput, N_COLORS) - 1,
        "required_lambda": (f + 1) / (32.0 * n),
        "satisfies_c8": lam >= (f + 1) / (32.0 * n),
    }


@dataclasses.dataclass
class FaultSweepResult:
    color: int
    routed: RoutingResult
    connected: bool
    repair: Optional[RepairResult] = None   # set in repair mode


def fault_sweep(topo: Topology, at: ATResult, K: int = 6, seed: int = 0,
                repair_from: Optional[ServingState] = None,
                rng: Optional[np.random.Generator] = None,
                device=None) -> List[FaultSweepResult]:
    """Re-route under each single-OCS fault using the (robust) AT set.

    ``repair_from`` switches the sweep to the incremental path: each
    fault is repaired from that live :class:`ServingState`
    (:func:`repro_torch.core.repair.repair_fault`) instead of re-selecting
    every flow against the masked AT -- each color independently, like
    the recompute mode. The per-fault :class:`RepairResult` rides on the
    sweep entries.

    All randomness is explicit: pass one ``np.random.Generator`` as
    ``rng`` and every per-color selection draws its seed from it (no
    module-level RNG anywhere on the fault path), so a sweep replays
    bit-identically from the generator's seed; with ``rng=None`` every
    color uses the fixed ``seed`` (the legacy behaviour, equally
    deterministic). ``device`` (``None`` = CUDA, which raises when no
    GPU is present) goes to ``route_pod`` in recompute mode.
    """
    out = []
    for color in colors_in_use(topo):
        dead = dead_channels_for_color(at, color)
        if repair_from is not None:
            rr = repair_fault(repair_from, dead)
            st = rr.state
            routed = RoutingResult(
                st.table, st.loads[:-1].astype(np.float64),
                float(rr.l_max), st.table.avg_hops(), rr.unreachable,
                stats=rr.stats)
            out.append(FaultSweepResult(color, routed,
                                        rr.unreachable == 0, repair=rr))
        else:
            s = seed if rng is None else int(rng.integers(0, 2**31 - 1))
            cfg = PipelineConfig(K=K, seed=s, engine="array",
                                 local_search_rounds=3, vc="none")
            routed = route_pod(topo, cfg, at=at, dead_channels=dead,
                               device=device).routed
            out.append(FaultSweepResult(color, routed,
                                        routed.unreachable == 0))
    return out
