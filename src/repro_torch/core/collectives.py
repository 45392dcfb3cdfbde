"""Collective schedulers over arbitrary pod topologies (paper Section 6.1.2).

- all-gather / all-reduce: MultiTree-style greedy broadcast/reduction trees
  (one tree per root, edges picked to balance channel usage) [38].
- all-to-all: schedule quality from the routed min-max channel load,
  bounded by the MCF-derived limit (Basu et al. style) [5].

Quality metric: link utilisation = useful chunk-transmissions divided by
(schedule length x number of channels), as in Fig. 6. These schedules also
drive the collective term of the framework's roofline model and can be
exported as traces for the cycle-level simulator (Fig. 7).

Port of ``repro.core.collectives``: host numpy on the port's
``Channels`` and ``RoutingResult``, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.routing import Channels, RoutingResult
from repro_torch.core.topology import Topology


@dataclasses.dataclass
class Schedule:
    kind: str
    epochs: float              # schedule length in link-serialisation units
    transmissions: float       # total chunk-hops
    n_channels: int
    ideal_epochs: float        # lower bound

    @property
    def utilization(self) -> float:
        return self.transmissions / (self.epochs * self.n_channels)

    @property
    def ideal_utilization(self) -> float:
        return self.transmissions / max(self.ideal_epochs, 1e-12) \
            / self.n_channels


def broadcast_trees(topo: Topology) -> Tuple[np.ndarray, List[Dict]]:
    """One BFS broadcast tree per root, greedily preferring low-load
    channels (MultiTree-flavoured). Returns per-channel usage counts."""
    ch = Channels.from_topology(topo)
    adj = topo.adjacency()
    n = topo.n
    loads = np.zeros(ch.n)
    trees = []
    for root in range(n):
        seen = np.zeros(n, bool)
        seen[root] = True
        frontier = [root]
        tree = {}
        while frontier:
            nxt = []
            # expand lowest-load channels first
            cand = []
            for u in frontier:
                for v in adj[u]:
                    if not seen[v]:
                        c = ch.index[(u, v)]
                        cand.append((loads[c], c, u, v))
            cand.sort()
            for _, c, u, v in cand:
                if seen[v]:
                    continue
                seen[v] = True
                tree[v] = (u, c)
                loads[c] += 1
                nxt.append(v)
            frontier = nxt
        trees.append(tree)
    return loads, trees


def all_gather(topo: Topology) -> Schedule:
    """Each node's shard broadcast to all others along its tree."""
    loads, _ = broadcast_trees(topo)
    n = topo.n
    transmissions = float(n * (n - 1))
    n_channels = 2 * len(topo.edges())
    ideal = transmissions / n_channels
    return Schedule("all-gather", float(loads.max()), transmissions,
                    n_channels, ideal)


def all_reduce(topo: Topology) -> Schedule:
    """reduce-scatter + all-gather (each a tree pass): 2x the traffic."""
    ag = all_gather(topo)
    return Schedule("all-reduce", 2 * ag.epochs, 2 * ag.transmissions,
                    ag.n_channels, 2 * ag.ideal_epochs)


def all_to_all(topo: Topology, routed: RoutingResult,
               mcf_lambda: Optional[float] = None) -> Schedule:
    """One chunk per ordered pair along the selected static paths; the
    schedule length is the max channel load; the MCF limit is 1/lambda."""
    transmissions = float(routed.table.hops.sum())
    n_channels = 2 * len(topo.edges())
    ideal = 1.0 / mcf_lambda if mcf_lambda else \
        transmissions / n_channels
    return Schedule("all-to-all", routed.l_max, transmissions, n_channels,
                    ideal)


def collective_report(topo: Topology, routed: RoutingResult,
                      mcf_lambda: Optional[float] = None) -> Dict[str, Dict]:
    out = {}
    for sched in (all_gather(topo), all_reduce(topo),
                  all_to_all(topo, routed, mcf_lambda)):
        out[sched.kind] = {
            "epochs": sched.epochs,
            "utilization": sched.utilization,
            "mcf_limit_utilization": min(1.0, sched.ideal_utilization),
        }
    return out


def effective_a2a_bandwidth(topo_lambda: float, n: int,
                            link_bw: float = 50e9) -> float:
    """Framework integration: sustained per-node all-to-all injection
    bandwidth implied by the topology's MCF (used by the roofline's
    collective term): lambda * (n-1) * link_bw per node."""
    return topo_lambda * (n - 1) * link_bw


# ---------------------------------------------------------------------------
# Trace export (Fig. 7-style trace-driven simulation)
# ---------------------------------------------------------------------------


def a2a_trace(topo: Topology, routed: RoutingResult, chunks_per_pair: int = 1
              ) -> List[Tuple[int, int, int]]:
    """(src, dst, n_chunks) trace for the packet simulator (API edge)."""
    ss, dd = np.nonzero(routed.table.routed_mask())
    return [(int(s), int(d), chunks_per_pair) for s, d in zip(ss, dd)]


def a2a_traffic(routed: RoutingResult):
    """All-to-all as a simulator TrafficPattern: uniform demand over every
    routed ordered pair (equals uniform-random when all pairs route, and
    respects unreachable pairs under faults)."""
    from repro_torch.core.traffic import TrafficPattern
    return TrafficPattern.from_matrix(
        "all-to-all", routed.table.routed_mask().astype(np.float64))
