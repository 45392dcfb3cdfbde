"""Online fault-reactive repair: incremental re-route on OCS/link failure.

Port of ``repro.core.repair``: numpy and scipy on the host, unchanged
except that :meth:`ServingState.build` passes ``device`` to
:func:`~repro_torch.core.pipeline.route_pod`, so the cold build's APL
hop matrix comes from the (min,+) APSP kernel on the card.

The cold pipeline treats every fault as a full rebuild -- allowed-turn
admission over every base turn, BFS + selection over every flow, VC
allocation over every hop (minutes at 12^3). No pod serving live traffic
can afford that per fault. This module repairs a live
:class:`ServingState` *incrementally*, exploiting three structural
facts:

1. **Turn pruning is closed** (delta admission). Killing a channel kills
   exactly the turns whose in- or out-channel died; every surviving
   accepted turn was admitted against a *larger* DAG, and a subgraph of
   a DAG is a DAG under the same topological numbering. So the batched
   engine's admission snapshot (:attr:`ATResult._admission`) can be
   patched in place: drop dead rows from the accepted grid, keep the
   level numbering, done -- no turn is replayed. Only when pruning
   disconnects some pair does :func:`_readmit` resume the batched
   admission (prime a fresh :class:`_BatchedDAG` with the kept edges
   under the saved levels, then re-admit the non-accepted candidate
   cells through the normal ``admit_grid`` machinery) -- with a robust
   AT's OCS-disjoint trees this is the rare path.

2. **Untouched flows stay valid** (selective re-selection). A flow whose
   path crosses no dead channel uses only surviving turns (a turn dies
   only with its channels), so its path *and* its VC assignment remain
   exactly valid -- byte-for-byte untouched. Only the flows crossing
   dead channels are pooled: their load is subtracted from the live
   channel-load vector, they are re-walked at full K against the
   distance fields captured at build time (dead states masked out), and
   re-optimised by the sharded engine's own refinement primitive
   (:func:`repro_torch.core.routing._refine_candidates`) against the true
   background load. Stored distances can be *stale* after a fault --
   a completed walk is still a real path (soundness), only completeness
   suffers -- so flows whose walkers all die get an exact per-source
   BFS on the pruned AT (write-back, copy-on-write), a small residual
   in practice.

3. **VC re-repair streams over the pool** (and only the pool). Old
   per-VC hop counts of pooled flows are subtracted and the
   exact-lookahead allocator re-runs over just those flows
   (:func:`repro_torch.core.vcalloc.reallocate_vcs`); deadlock freedom of the
   result is re-verified against the pruned state graph.

`repair_fault(state, dead_channels)` returns a :class:`RepairResult`
carrying per-stage wall-clock, the re-routed flow count and the
post-repair ``l_max``; the repaired state is reachability- and
deadlock-equivalent to a full recompute on the faulted fabric (the
oracle `full_recompute` runs the whole selection + allocation from
scratch in the same channel-id space).

**Degraded mode** (default): when a fault genuinely disconnects some
pairs, the state keeps serving every reachable pair instead of giving
up. Lost pairs keep their flow slot with a zero-length path -- flow ids
stay stable across the whole fault/heal timeline -- and accumulate in
``ServingState.lost``; every invariant (loads, VC counts, deadlock
freedom, untouched-flow bit-identity) holds over the reachable subset.
``repair_fault(..., on_disconnect="recompute")`` restores the legacy
behaviour of falling back to a cold re-selection (which renumbers
flows, since unreachable pairs get no flow entry).

**Restoration** (:func:`restore_channels`) is the inverse walk: revived
channels re-enter turn admission incrementally -- partial heals resume
the batched engine over the saved snapshot (:func:`_readmit`), a full
heal swaps back the pristine cold admission kept on
``ServingState.at0`` for exact pre-fault recovery -- then previously
lost pairs re-route and, with ``rebalance=True``, every flow detoured
during the fault epoch (``ServingState.touched``) re-routes against
fresh exact distances so the healed fabric's ``l_max`` lands within a
few percent of a cold rebuild.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from repro_torch.core.pathtable import CSRPathTable
from repro_torch.core.routing import (ATResult, Channels, RoutingResult,
                                      _BatchedDAG, _dead_channel_array,
                                      _refine_candidates, _walk_flows,
                                      allowed_turns, node_distances,
                                      select_paths)
from repro_torch.core.topology import Topology
from repro_torch.core.vcalloc import allocate_vcs, reallocate_vcs, \
    verify_deadlock_free, verify_flows_deadlock_free


class _LazyAllowed:
    """Set-compatible view of the allowed turns, materialised from the
    packed state-edge array only if a python consumer (the reference
    oracles, equivalence tests) actually touches it. The repair hot path
    never does -- everything downstream runs on the compiled
    ``StateGraph`` -- and building millions of tuple pairs would eat the
    time-to-recover budget."""

    def __init__(self, edges: np.ndarray, n_vc: int):
        self._edges = edges
        self._n_vc = n_vc
        self._set: Optional[set] = None

    def _materialise(self) -> set:
        if self._set is None:
            a, b = self._edges[:, 0], self._edges[:, 1]
            v = self._n_vc
            self._set = set(zip(zip((a // v).tolist(), (a % v).tolist()),
                                zip((b // v).tolist(), (b % v).tolist())))
        return self._set

    def __contains__(self, key) -> bool:
        return key in self._materialise()

    def __iter__(self):
        return iter(self._materialise())

    def __len__(self) -> int:
        return len(self._edges)

    def __bool__(self) -> bool:
        return len(self._edges) > 0


@dataclasses.dataclass
class ServingState:
    """A live routed fabric: everything the repair path needs to patch
    instead of rebuild.

    ``loads`` is the integer per-channel load vector with the selection
    engines' sentinel slot appended (``loads[n_ch]`` stays 0); ``dist``
    / ``best`` are the per-source BFS state-distance ``(n, S) int8`` and
    node-distance ``(n, n) int16`` fields captured during the cold
    build -- repairs re-walk pooled flows against them instead of
    re-running the BFS. ``dead`` accumulates every channel killed so
    far (sorted). States share ``dist``/``best`` read-only across a
    repair chain; a repair copies them before writing back refreshed
    rows (copy-on-write).

    ``lost`` holds the flow ids currently unroutable (degraded mode --
    their table slots are zero-length so flow ids never shift);
    ``touched`` accumulates every flow re-routed since the cold build
    (the set :func:`restore_channels` rebalances after a heal, and the
    only flows that may ride turns re-admitted mid-fault). ``at0``
    keeps the pristine cold-build ATResult: repairs never mutate it
    (pruning copies the admission snapshot), so a full heal can restore
    the exact pre-fault allowed set instead of replaying admission.
    """
    topo: Topology
    at: ATResult
    table: CSRPathTable
    loads: np.ndarray          # (n_ch + 1,) int64, sentinel slot last
    vc_counts: np.ndarray      # (n_vc,) hops per VC
    dead: np.ndarray           # (D,) sorted int64 dead channel ids
    dist: np.ndarray           # (n, S) int8 state distances, -1 pad
    best: np.ndarray           # (n, n) int16 node distances, -1 pad
    K: int
    seed: int
    stats: Optional[dict] = None
    lost: Optional[np.ndarray] = None      # sorted int64 lost flow ids
    touched: Optional[np.ndarray] = None   # sorted int64 re-routed flows
    at0: Optional[ATResult] = None         # pristine cold-build AT

    def __post_init__(self) -> None:
        if self.lost is None:
            self.lost = np.zeros(0, np.int64)
        if self.touched is None:
            self.touched = np.zeros(0, np.int64)

    @staticmethod
    def build(topo: Topology, n_vc: int = 4, K: int = 8, seed: int = 0,
              robust: bool = True, priority: str = "apl", device=None,
              **select_kw) -> "ServingState":
        """Cold build via :func:`repro_torch.core.pipeline.route_pod`: robust
        allowed turns -> sharded selection (with the distance-field
        capture hooks) -> in-place balanced VC allocation. ``device``
        (``None`` = CUDA, which raises when no GPU is present) computes
        the APL priority's all-pairs hop matrix."""
        from repro_torch.core.pipeline import PipelineConfig, route_pod

        cfg = PipelineConfig(n_vc=n_vc, K=K, seed=seed, robust=robust,
                             priority=priority, engine="sharded",
                             local_search_rounds=3, vc="inplace")
        ch = Channels.from_topology(topo)
        n, S = ch.n_nodes, ch.n * n_vc
        dist = np.full((n, S), -1, np.int8)
        best = np.full((n, n), -1, np.int16)
        rp = route_pod(topo, cfg, dist_out=dist, best_out=best,
                       select_kw=select_kw, device=device)
        at, routed = rp.at, rp.routed
        loads = np.zeros(ch.n + 1, np.int64)
        loads[:ch.n] = routed.loads.astype(np.int64)
        return ServingState(topo, at, routed.table, loads, rp.vc_counts,
                            np.zeros(0, np.int64), dist, best, K, seed,
                            stats=routed.stats, at0=at)

    @property
    def l_max(self) -> float:
        return float(self.loads[:-1].max()) if len(self.loads) > 1 else 0.0

    @property
    def served_fraction(self) -> float:
        """Fraction of the fabric's flow slots currently routable --
        the availability metric a chaos campaign tracks over time."""
        F = self.table.n_flows
        return 1.0 if F == 0 else 1.0 - len(self.lost) / F


@dataclasses.dataclass
class RepairResult:
    """Outcome of one :func:`repair_fault` / :func:`restore_channels`
    call. ``stats`` carries the per-stage wall-clock (``prune_s``,
    ``walk_s``, ``bfs_s``, ``readmit_s``, ``greedy_s``, ``refine_s``,
    ``vc_s``, ``verify_s``, ``total_s``) plus pool/residual sizes; it
    is JSON-serialised by the benchmark lanes, so everything in it
    stays scalar. The re-routed flow-id pool rides separately on
    ``pool_flows`` (the complement is the untouched set whose paths
    must be bit-identical to the pre-event table)."""
    state: ServingState
    flows_rerouted: int
    l_max: float
    unreachable: int
    deadlock_free: bool
    fallback: bool             # repair gave up -> full re-selection
    readmitted: int            # turns re-admitted by the delta admission
    stats: dict
    lost: int = 0              # flow slots unroutable after this event
    restored: int = 0          # channels revived (restore events only)
    pool_flows: Optional[np.ndarray] = None   # re-routed flow ids


def _pruned_at(at: ATResult, dead_mask: np.ndarray) -> ATResult:
    """Delta allowed-turns admission, the closed (common) case: drop
    every accepted turn touching a dead channel from the admission
    snapshot and rebuild the packed edge array. The saved topological
    levels stay valid -- every kept edge was level-increasing before and
    edge deletion cannot create a cycle -- so nothing is replayed."""
    adm = at._admission
    if adm is None:
        raise ValueError("repair requires an ATResult from the batched "
                         "admission engine (at_engine='batched'); the "
                         "reference engine keeps no admission snapshot")
    n_vc = at.n_vc
    turns, vo = adm["turns"], adm["vo"]
    cin = turns[:, 0].astype(np.int64)
    cout = turns[:, 1].astype(np.int64)
    turn_dead = dead_mask[cin] | dead_mask[cout]
    acc2 = adm["acc"] & ~turn_dead[:, None]
    tr, tv = np.nonzero(acc2)
    edges = np.stack([cin[tr] * n_vc + vo[tv, 0],
                      cout[tr] * n_vc + vo[tv, 1]], axis=1)
    adm2 = {"level": adm["level"].copy(), "acc": acc2, "turns": turns,
            "vo": vo, "perm": adm["perm"], "cap_out": adm["cap_out"],
            "dead_turn": adm["dead_turn"] | turn_dead}
    stats = {"engine": "repair-pruned",
             "pruned_turn_cells": int((adm["acc"] & ~acc2).sum()),
             "allowed": len(edges)}
    return ATResult(at.channels, n_vc, _LazyAllowed(edges, n_vc),
                    trees=at.trees, stats=stats, _edges=edges,
                    _admission=adm2)


def _revived_at(at: ATResult, dead_mask: np.ndarray) -> ATResult:
    """Delta admission for a *partial* heal: recompute the dead-turn
    mask from the (smaller) surviving dead set, keep the accepted grid
    as is. A revived turn is NOT auto-re-accepted -- it was admitted
    against a DAG that has since changed -- it re-enters through
    :func:`_readmit`'s resumed batched admission under the saved level
    numbering, which guarantees the result stays acyclic."""
    adm = at._admission
    if adm is None:
        raise ValueError("restore requires an ATResult from the batched "
                         "admission engine (at_engine='batched'); the "
                         "reference engine keeps no admission snapshot")
    n_vc = at.n_vc
    turns, vo = adm["turns"], adm["vo"]
    cin = turns[:, 0].astype(np.int64)
    cout = turns[:, 1].astype(np.int64)
    turn_dead = dead_mask[cin] | dead_mask[cout]
    acc2 = adm["acc"].copy()    # accepted turns avoid the old dead set,
    tr, tv = np.nonzero(acc2)   # a superset of the healed one
    edges = np.stack([cin[tr] * n_vc + vo[tv, 0],
                      cout[tr] * n_vc + vo[tv, 1]], axis=1)
    adm2 = {"level": adm["level"].copy(), "acc": acc2, "turns": turns,
            "vo": vo, "perm": adm["perm"], "cap_out": adm["cap_out"],
            "dead_turn": turn_dead}
    stats = {"engine": "repair-restored",
             "revived_turn_cells": int((adm["dead_turn"]
                                        & ~turn_dead).sum()),
             "allowed": len(edges)}
    return ATResult(at.channels, n_vc, _LazyAllowed(edges, n_vc),
                    trees=at.trees, stats=stats, _edges=edges,
                    _admission=adm2)


def _readmit(at2: ATResult) -> int:
    """Resume the batched admission over the shrunken DAG: prime a fresh
    engine with the kept edges under the saved level numbering, then
    push every not-yet-accepted candidate cell of every live turn back
    through ``admit_grid`` (full-pass semantics). Exact -- the engine's
    forward/BFS/SCC/tangle ladder guarantees the result is acyclic --
    and only reached when pruning broke reachability. Returns the number
    of newly admitted VC-labeled turns; mutates ``at2`` in place
    (its accepted grid, packed edges and cached state graph)."""
    adm = at2._admission
    n_vc = at2.n_vc
    turns, vo, perm = adm["turns"], adm["vo"], adm["perm"]
    acc, dead_turn = adm["acc"], adm["dead_turn"]
    T, n_vo = acc.shape
    cin = turns[:, 0].astype(np.int64)
    cout = turns[:, 1].astype(np.int64)
    U = cin[:, None] * n_vc + vo[None, :, 0]
    V = cout[:, None] * n_vc + vo[None, :, 1]
    engstats = {"blocks": 0, "fwd_bulk": 0, "contested_bulk": 0,
                "bfs_rows": 0, "scc_checks": 0, "conflict_rounds": 0,
                "tangle_commits": 0, "admitted_per_block": []}
    S = at2.channels.n * n_vc
    eng = _BatchedDAG(S, adm["cap_out"], engstats)
    er, ec = np.nonzero(acc)
    eng.accept(U[er, ec].astype(np.int64), V[er, ec].astype(np.int64))
    eng.level = adm["level"].copy()
    rej = np.repeat(dead_turn[:, None], n_vo, axis=1)
    newly = 0
    block = 1024
    for i in range(0, T, block):
        b = perm[i:i + block]
        res, _ = eng.admit_grid(U[b], V[b], acc[b], rej[b],
                                first_only=False)
        if res.any():
            acc[b] |= res
            newly += int(res.sum())
    if newly:
        tr, tv = np.nonzero(acc)
        edges = np.stack([cin[tr] * n_vc + vo[tv, 0],
                          cout[tr] * n_vc + vo[tv, 1]], axis=1)
        at2._edges = edges
        at2.allowed = _LazyAllowed(edges, n_vc)
        at2._sg = None
        at2._by_in = None
        adm["level"] = eng.level
        if at2.stats is not None:
            at2.stats["allowed"] = len(edges)
    return newly


def _walk_pool_chunked(at2: ATResult, dist_store: np.ndarray,
                       best_store: np.ndarray, dead_state: np.ndarray,
                       psrc: np.ndarray, pdst: np.ndarray, K: int,
                       chunk: int = 64):
    """Re-walk an arbitrary (source-sorted) flow pool against the stored
    distance fields with the dead states masked out. Returns SEN-padded
    ``(cand (P, K, Lp), vc, k_valid, lens)``; flows whose stored node
    distance is gone (``<= 0``) come back all-invalid (residual)."""
    sg = at2.state_graph()
    ch = at2.channels
    n, n_vc = ch.n_nodes, at2.n_vc
    SEN = ch.n
    P = len(psrc)
    lens = best_store[psrc, pdst].astype(np.int64)
    parts = []
    spans = []
    Lp = 1
    usrc = np.unique(psrc)
    bounds = np.searchsorted(psrc, usrc[::chunk])
    bounds = np.append(bounds, P)
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == b:
            continue
        srcs = np.unique(psrc[a:b])
        sub = np.nonzero(lens[a:b] > 0)[0]
        if not len(sub):
            spans.append((a, b, None))
            continue
        dist = dist_store[srcs].astype(np.int16)
        dist[:, dead_state] = -1
        best = best_store[srcs]
        fb = np.searchsorted(srcs, psrc[a:b][sub])
        fl = lens[a:b][sub]
        cc, vv, kvp = _walk_flows(
            sg, n, n_vc, SEN, dist, best, srcs, fb, pdst[a:b][sub], fl,
            np.full(len(sub), K, np.int64), K, uniq=None)
        parts.append((cc, vv, kvp, sub))
        spans.append((a, b, len(parts) - 1))
        Lp = max(Lp, cc.shape[2])
    cand = np.full((P, K, Lp), SEN, np.int64)
    vcs = np.zeros((P, K, Lp), np.int8)
    kv = np.zeros((P, K), bool)
    for a, b, pi in spans:
        if pi is None:
            continue
        cc, vv, kvp, sub = parts[pi]
        rows = a + sub
        cand[rows, :, :cc.shape[2]] = cc
        vcs[rows, :, :cc.shape[2]] = vv
        kv[rows] = kvp
    return cand, vcs, kv, lens


def _exact_bfs(at2: ATResult, srcs: np.ndarray, dead_all: np.ndarray,
               chunk: int = 1024) -> np.ndarray:
    """Exact multi-source state BFS on the pruned AT: one augmented
    graph (a virtual node per source with unit edges into its live seed
    states) solved by an unweighted csgraph sweep. Matches
    :func:`routing.state_bfs` bit-for-bit -- the pruned edge set has no
    arcs into dead states, so masking the seeds suffices -- and is
    faster because the level loop runs in compiled code."""
    ch = at2.channels
    n_vc = at2.n_vc
    S = ch.n * n_vc
    B = len(srcs)
    deg = (ch.out_indptr[srcs + 1] - ch.out_indptr[srcs]).astype(np.int64)
    starts = ch.out_indptr[srcs].astype(np.int64)
    idx = np.repeat(starts - (np.cumsum(deg) - deg), deg) \
        + np.arange(int(deg.sum()), dtype=np.int64)
    seed_ch = ch.out_chan[idx].astype(np.int64)
    seed_st = (seed_ch[:, None] * n_vc + np.arange(n_vc)).ravel()
    rows = np.repeat(np.arange(B, dtype=np.int64), deg * n_vc)
    live = np.ones(len(seed_st), bool)
    if len(dead_all):
        dead_state = np.zeros(S, bool)
        dead_state[(dead_all[:, None] * n_vc
                    + np.arange(n_vc)).ravel()] = True
        live = ~dead_state[seed_st]
    e = at2._edges
    es = np.concatenate([e[:, 0], S + rows[live]])
    ed = np.concatenate([e[:, 1], seed_st[live]])
    m = sp.csr_matrix((np.ones(len(es), np.float32), (es, ed)),
                      shape=(S + B, S + B))
    out = np.empty((B, S), np.int16)
    for i in range(0, B, chunk):
        sub = np.arange(i, min(i + chunk, B))
        dmat = csgraph.dijkstra(m, directed=True, indices=S + sub,
                                unweighted=True)[:, :S]
        out[sub] = np.where(np.isinf(dmat), -1, dmat).astype(np.int16)
    return out


def _validated_dead(dead_channels, n_ch: int) -> np.ndarray:
    """Normalise a dead-channel list for the repair entry points:
    deduplicated sorted int64 ids (``_dead_channel_array``), with ids
    outside ``[0, n_ch)`` rejected loudly -- a negative id would
    otherwise wrap through numpy fancy indexing and silently corrupt an
    unrelated channel's state."""
    dc = _dead_channel_array(dead_channels)
    if dc is None:
        return np.zeros(0, np.int64)
    bad = dc[(dc < 0) | (dc >= n_ch)]
    if len(bad):
        raise ValueError(f"unknown channel ids {bad.tolist()} "
                         f"(topology has {n_ch} channels)")
    return dc


def _greedy_assign(loads: np.ndarray, cand: np.ndarray, kv: np.ndarray,
                   routable: np.ndarray, rng, SEN: int, BIG: np.int64,
                   block: int) -> np.ndarray:
    """Blockwise min-max greedy over a random pool order against the
    live background loads: each flow takes the candidate minimising
    (max load along path, sum of loads) lexicographically, committing
    its load before the next block. Returns per-pool-row chosen slot
    ids; mutates ``loads`` in place (sentinel slot kept at 0)."""
    pchosen = np.zeros(len(kv), np.int64)
    order = rng.permutation(routable)
    for i in range(0, len(order), block):
        idx = order[i:i + block]
        bc = cand[idx]
        l = loads[bc]
        cost = l.max(axis=2) * BIG + l.sum(axis=2)
        cost[~kv[idx]] = np.iinfo(np.int64).max
        c = cost.argmin(axis=1)
        pchosen[idx] = c
        np.add.at(loads, bc[np.arange(len(idx)), c].ravel(), 1)
        loads[SEN] = 0
    return pchosen


def _rebuild_table(table: CSRPathTable, pool: np.ndarray,
                   pool_hop_idx: np.ndarray, plens: np.ndarray,
                   kv: np.ndarray, cand: np.ndarray, vcs: np.ndarray,
                   pchosen: np.ndarray, SEN: int) -> CSRPathTable:
    """Rebuild the CSR arrays after a pool re-route: untouched flows
    shift in place via one cumsum/scatter (byte-identical hops),
    pooled flows scatter their winning candidate, unroutable pool
    flows come back as zero-length (lost) slots."""
    F = table.n_flows
    flen_all = table.flow_len.astype(np.int64)
    routable = np.nonzero(kv.any(axis=1))[0]
    flen2 = flen_all.copy()
    flen2[pool] = plens
    flen2[pool[~kv.any(axis=1)]] = 0
    hop_indptr2 = np.zeros(F + 1, np.int64)
    np.cumsum(flen2, out=hop_indptr2[1:])
    chan2 = np.full(int(hop_indptr2[-1]), SEN, np.int32)
    vc2 = np.zeros(int(hop_indptr2[-1]), np.int8)
    keep = np.ones(len(table.chan), bool)
    keep[pool_hop_idx] = False
    shift = hop_indptr2[:-1] - table.hop_indptr[:-1]
    new_pos = (np.arange(len(table.chan), dtype=np.int64)
               + np.repeat(shift, flen_all))[keep]
    chan2[new_pos] = table.chan[keep]
    vc2[new_pos] = table.vc[keep]
    if len(routable):
        rp = pool[routable]
        sel = cand[routable, pchosen[routable]]
        selvc = vcs[routable, pchosen[routable]]
        pos = np.arange(cand.shape[2])[None, :]
        live = pos < plens[routable][:, None]
        flat = (hop_indptr2[rp][:, None] + pos)[live]
        chan2[flat] = sel[live]
        vc2[flat] = selvc[live]
    return CSRPathTable(table.n, table.n_ch, table.n_vc,
                        table.src_indptr.copy(), table.dst.copy(),
                        hop_indptr2, chan2, vc2)


def _pool_hop_ranges(table: CSRPathTable,
                     pool: np.ndarray) -> np.ndarray:
    """Ragged hop index ranges of just the pool flows (~pool * avg hops
    entries, not all hops)."""
    plen = table.flow_len.astype(np.int64)[pool]
    return np.repeat(
        table.hop_indptr[pool] - (np.cumsum(plen) - plen), plen) \
        + np.arange(int(plen.sum()), dtype=np.int64)


def repair_fault(state: ServingState, dead_channels,
                 local_search_rounds: int = 1, refine_block: int = 192,
                 readmit: str = "auto", verify: str = "pool",
                 block: int = 4096, bfs_chunk: int = 1024,
                 on_disconnect: str = "degrade") -> RepairResult:
    """Incrementally repair a live :class:`ServingState` after
    ``dead_channels`` fail. Pure: the input state (its AT, table, loads,
    stores) is never mutated; the repaired state comes back on the
    :class:`RepairResult`.

    ``dead_channels`` is deduplicated; out-of-range or negative ids
    raise ``ValueError``. Channels already dead in the serving state are
    a no-op (their flows were re-routed when they first died) -- the
    repair only walks flows crossing *newly* dead channels, and
    ``stats["already_dead"]`` counts the redundant ids.

    ``readmit="auto"`` resumes turn admission only when pruning breaks
    reachability (``"never"`` disables it, ``"always"`` forces one
    pass). ``verify="pool"`` re-verifies the turns of re-routed flows
    only -- untouched flows keep using surviving turns by construction
    -- while ``"full"`` re-checks the whole table.

    ``on_disconnect`` picks the genuine-disconnection policy:
    ``"degrade"`` (default) serves every reachable pair and parks the
    disconnected ones as zero-length flow slots in
    ``ServingState.lost`` (flow ids stay stable; a later
    :func:`restore_channels` re-routes them); ``"recompute"`` falls
    back to a full re-selection on the pruned AT (legacy behaviour --
    flow ids shift because unreachable pairs get no flow entry, so the
    lost/touched bookkeeping resets).
    """
    if on_disconnect not in ("degrade", "recompute"):
        raise ValueError(f"on_disconnect must be 'degrade' or "
                         f"'recompute', got {on_disconnect!r}")
    t_all = time.time()
    stats: dict = {}
    at = state.at
    ch = at.channels
    n, n_vc = ch.n_nodes, at.n_vc
    SEN = ch.n
    K = state.K
    dc = _validated_dead(dead_channels, SEN)
    new = np.setdiff1d(dc, state.dead)
    stats["already_dead"] = int(len(dc) - len(new))
    dead_all = np.union1d(state.dead, dc)
    dead_mask = np.zeros(SEN, bool)
    dead_mask[dead_all] = True
    new_mask = np.zeros(SEN, bool)
    new_mask[new] = True
    dead_state = (dead_all[:, None] * n_vc
                  + np.arange(n_vc)).ravel() if len(dead_all) else \
        np.zeros(0, np.int64)

    # ---- stage A: delta allowed-turns admission (prune) -------------------
    t0 = time.time()
    at2 = _pruned_at(at, dead_mask)
    stats["prune_s"] = round(time.time() - t0, 3)
    readmitted = 0
    if readmit == "always":
        t0 = time.time()
        readmitted = _readmit(at2)
        stats["readmit_s_upfront"] = round(time.time() - t0, 3)

    # ---- stage B: selective re-selection ----------------------------------
    table = state.table
    F = table.n_flows
    flen_all = table.flow_len.astype(np.int64)
    # flows whose path crosses a newly-dead channel: searchsorted the
    # dead hop positions back to flow ids (cheaper than materialising
    # the tens-of-millions-entry hop->flow map at 12^3+)
    dead_hops = np.nonzero(new_mask[table.chan])[0]
    pool = np.unique(np.searchsorted(table.hop_indptr, dead_hops,
                                     side="right") - 1)
    stats["pool"] = len(pool)
    loads = state.loads.copy()
    counts = state.vc_counts.copy()
    dist_store, best_store = state.dist, state.best
    store_copied = False
    fallback = False
    unreachable = 0
    t_walk = t_bfs = t_readmit = t_greedy = t_refine = t_vc = 0.0
    rng = np.random.default_rng(state.seed)

    if len(pool):
        src_all = table.flow_src.astype(np.int64)
        psrc, pdst = src_all[pool], table.dst[pool].astype(np.int64)
        pool_hop_idx = _pool_hop_ranges(table, pool)
        loads[:SEN] -= np.bincount(table.chan[pool_hop_idx],
                                   minlength=SEN)
        loads[SEN] = 0
        counts = counts - np.bincount(
            table.vc[pool_hop_idx].astype(np.int64), minlength=n_vc)

        # stale-distance walk: completed chains are sound, dead walkers
        # form the residual that gets an exact BFS below
        t0 = time.time()
        cand, vcs, kv, plens = _walk_pool_chunked(
            at2, dist_store, best_store, dead_state, psrc, pdst, K)
        t_walk += time.time() - t0
        residual = np.nonzero(~kv.any(axis=1))[0]
        stats["residual"] = len(residual)
        for attempt in range(2):
            if not len(residual):
                break
            if attempt == 1:
                # the exact BFS still found nothing: only new turns can
                # help -- resume admission, then re-measure
                if readmit == "never" or readmitted:
                    break
                t0 = time.time()
                readmitted = _readmit(at2)
                t_readmit += time.time() - t0
                if not readmitted:
                    break
            t0 = time.time()
            rsrcs = np.unique(psrc[residual])
            if not store_copied:
                dist_store = dist_store.copy()
                best_store = best_store.copy()
                store_copied = True
            d = _exact_bfs(at2, rsrcs, dead_all, chunk=bfs_chunk)
            b = node_distances(at2, rsrcs, dist=d)
            dist_store[rsrcs] = d.astype(np.int8)
            best_store[rsrcs] = b.astype(np.int16)
            t_bfs += time.time() - t0
            t0 = time.time()
            rc, rv, rkv, rlens = _walk_pool_chunked(
                at2, dist_store, best_store, dead_state,
                psrc[residual], pdst[residual], K)
            t_walk += time.time() - t0
            Lp = max(cand.shape[2], rc.shape[2])
            if Lp > cand.shape[2]:
                grown = np.full((len(pool), K, Lp), SEN, np.int64)
                grown[:, :, :cand.shape[2]] = cand
                cand = grown
                gv = np.zeros((len(pool), K, Lp), np.int8)
                gv[:, :, :vcs.shape[2]] = vcs
                vcs = gv
            cand[residual, :, :rc.shape[2]] = rc
            cand[residual, :, rc.shape[2]:] = SEN
            vcs[residual, :, :rv.shape[2]] = rv
            vcs[residual, :, rv.shape[2]:] = 0
            kv[residual] = rkv
            plens[residual] = rlens
            residual = residual[~rkv.any(axis=1)]
        unreachable = int(len(residual))

        if unreachable and readmit != "never" \
                and on_disconnect == "recompute":
            # legacy policy: the pruned AT (even after re-admission)
            # cannot route some pooled flow along stored/exact fields --
            # give up on the incremental path, re-select everything
            fallback = True
        else:
            routable = np.nonzero(kv.any(axis=1))[0]
            # same min-max tie-break base as the selection engines:
            # strictly larger than any sum-of-loads along one path
            BIG = np.int64(F) * max(int(flen_all.max()), 1) + 1
            t0 = time.time()
            pchosen = _greedy_assign(loads, cand, kv, routable, rng,
                                     SEN, BIG, block)
            t_greedy += time.time() - t0
            # the sharded engine's refinement primitive over the pool
            t0 = time.time()
            if local_search_rounds > 0 and len(routable):
                lm_before = int(loads[:SEN].max())
                loads, sub_chosen = _refine_candidates(
                    loads, cand[routable], kv[routable],
                    pchosen[routable].copy(), rng, SEN, BIG,
                    local_search_rounds, refine_block, lm_before)
                pchosen[routable] = sub_chosen
            t_refine += time.time() - t0
            table = _rebuild_table(table, pool, pool_hop_idx, plens,
                                   kv, cand, vcs, pchosen, SEN)
    else:
        stats["residual"] = 0
        table = state.table.copy()

    if fallback:
        # full re-selection + allocation on the pruned AT -- same
        # channel-id space, full recompute semantics
        t0 = time.time()
        routed = select_paths(at2, K=K, seed=state.seed,
                              engine="sharded", dead_channels=dead_all)
        table = routed.table
        loads = np.zeros(SEN + 1, np.int64)
        loads[:SEN] = routed.loads.astype(np.int64)
        counts = allocate_vcs(at2, table)
        unreachable = routed.unreachable
        stats["fallback_s"] = round(time.time() - t0, 3)
    elif len(pool):
        # ---- stage C: streamed VC re-repair over the pool -----------------
        t0 = time.time()
        counts = reallocate_vcs(at2, table, pool, counts)
        t_vc += time.time() - t0

    t0 = time.time()
    if verify == "full" or fallback:
        deadlock_free = verify_deadlock_free(at2, table)
    elif len(pool):
        deadlock_free = verify_flows_deadlock_free(at2, table, pool)
    else:
        deadlock_free = True
    stats["verify_s"] = round(time.time() - t0, 3)

    stats.update({"walk_s": round(t_walk, 3), "bfs_s": round(t_bfs, 3),
                  "readmit_s": round(t_readmit, 3),
                  "greedy_s": round(t_greedy, 3),
                  "refine_s": round(t_refine, 3),
                  "vc_s": round(t_vc, 3)})
    if not store_copied and not fallback:
        dist_store, best_store = state.dist, state.best
    if fallback:
        # the fallback re-selection renumbers flows (unreachable pairs
        # get no entry), so the flow-id bookkeeping resets
        lost2 = np.zeros(0, np.int64)
        touched2 = np.zeros(0, np.int64)
    elif len(pool):
        routable_m = kv.any(axis=1)
        lost2 = np.union1d(state.lost, pool[~routable_m])
        touched2 = np.union1d(state.touched, pool[routable_m])
    else:
        lost2, touched2 = state.lost, state.touched
    stats["lost"] = int(len(lost2))
    new_state = ServingState(state.topo, at2, table, loads, counts,
                             dead_all, dist_store, best_store, K,
                             state.seed, stats=state.stats, lost=lost2,
                             touched=touched2, at0=state.at0)
    stats["total_s"] = round(time.time() - t_all, 3)
    return RepairResult(new_state, flows_rerouted=len(pool),
                        l_max=float(loads[:SEN].max()),
                        unreachable=unreachable,
                        deadlock_free=bool(deadlock_free),
                        fallback=fallback, readmitted=readmitted,
                        stats=stats, lost=int(len(lost2)),
                        pool_flows=pool)


def restore_channels(state: ServingState, channels, rebalance: bool = True,
                     local_search_rounds: int = 1, refine_block: int = 192,
                     verify: str = "pool", block: int = 4096,
                     bfs_chunk: int = 1024) -> RepairResult:
    """Heal a live :class:`ServingState` after ``channels`` come back --
    the inverse of :func:`repair_fault`. Pure like the repair: the
    input state is never mutated.

    Revived turns re-enter admission incrementally: a *partial* heal
    rebuilds the dead-turn mask from the surviving dead set and resumes
    the batched engine over the saved snapshot (:func:`_readmit`, saved
    level numbering, acyclic by construction); a *full* heal (nothing
    left dead) swaps back the pristine cold admission kept on
    ``ServingState.at0`` -- the exact pre-fault allowed set, so
    reachability recovery is exact by construction, with no replay.

    The re-route pool is ``state.lost`` (pairs parked by degraded-mode
    repairs -- they re-route against fresh exact distances) plus, with
    ``rebalance=True``, ``state.touched``: every flow detoured during
    the fault epoch re-routes so load concentrated on detours relaxes
    back toward a cold rebuild's balance. On a full heal the touched
    set is pooled regardless -- those are the only flows that can ride
    turns re-admitted mid-fault, which the pristine admission does not
    contain. Untouched flows stay byte-identical.

    Channels not currently dead are counted in ``stats["not_dead"]``
    and ignored; out-of-range ids raise ``ValueError``.
    """
    t_all = time.time()
    stats: dict = {}
    at = state.at
    ch = at.channels
    n, n_vc = ch.n_nodes, at.n_vc
    SEN = ch.n
    K = state.K
    dc = _validated_dead(channels, SEN)
    revived = np.intersect1d(dc, state.dead)
    stats["not_dead"] = int(len(dc) - len(revived))
    dead_all = np.setdiff1d(state.dead, revived)
    dead_mask = np.zeros(SEN, bool)
    dead_mask[dead_all] = True
    dead_state = (dead_all[:, None] * n_vc
                  + np.arange(n_vc)).ravel() if len(dead_all) else \
        np.zeros(0, np.int64)
    full_heal = len(dead_all) == 0 and state.at0 is not None

    # ---- stage A: delta re-admission over the healed fabric ---------------
    t0 = time.time()
    readmitted = 0
    if not len(revived):
        at2 = at
    elif full_heal:
        at2 = state.at0
        stats["exact_heal"] = True
    else:
        at2 = _revived_at(at, dead_mask)
        readmitted = _readmit(at2)
    stats["readmit_s"] = round(time.time() - t0, 3)

    table = state.table
    F = table.n_flows
    flen_all = table.flow_len.astype(np.int64)
    pool = state.lost
    if rebalance or full_heal:
        pool = np.union1d(pool, state.touched)
    pool = pool.astype(np.int64)
    stats["pool"] = len(pool)
    stats["lost_before"] = int(len(state.lost))
    loads = state.loads.copy()
    counts = state.vc_counts.copy()
    dist_store, best_store = state.dist, state.best
    unreachable = 0
    t_walk = t_bfs = t_greedy = t_refine = t_vc = 0.0
    rng = np.random.default_rng(state.seed)
    lost2, touched2 = state.lost, state.touched

    if len(pool):
        src_all = table.flow_src.astype(np.int64)
        psrc, pdst = src_all[pool], table.dst[pool].astype(np.int64)
        pool_hop_idx = _pool_hop_ranges(table, pool)
        loads[:SEN] -= np.bincount(table.chan[pool_hop_idx],
                                   minlength=SEN)
        loads[SEN] = 0
        counts = counts - np.bincount(
            table.vc[pool_hop_idx].astype(np.int64), minlength=n_vc)

        # exact distance refresh for every pooled source: the stored
        # fields reflect the faulted fabric, and stale distances are
        # only sound on a *subgraph* -- healing grows the graph, so the
        # lost/touched walks need fresh exact BFS rows (copy-on-write)
        t0 = time.time()
        rsrcs = np.unique(psrc)
        dist_store = dist_store.copy()
        best_store = best_store.copy()
        d = _exact_bfs(at2, rsrcs, dead_all, chunk=bfs_chunk)
        b = node_distances(at2, rsrcs, dist=d)
        dist_store[rsrcs] = d.astype(np.int8)
        best_store[rsrcs] = b.astype(np.int16)
        t_bfs += time.time() - t0

        t0 = time.time()
        cand, vcs, kv, plens = _walk_pool_chunked(
            at2, dist_store, best_store, dead_state, psrc, pdst, K)
        t_walk += time.time() - t0
        routable_m = kv.any(axis=1)
        unreachable = int((~routable_m).sum())
        routable = np.nonzero(routable_m)[0]
        BIG = np.int64(F) * max(int(flen_all.max()),
                                int(plens.max(initial=1)), 1) + 1
        t0 = time.time()
        pchosen = _greedy_assign(loads, cand, kv, routable, rng, SEN,
                                 BIG, block)
        t_greedy += time.time() - t0
        t0 = time.time()
        if local_search_rounds > 0 and len(routable):
            lm_before = int(loads[:SEN].max())
            loads, sub_chosen = _refine_candidates(
                loads, cand[routable], kv[routable],
                pchosen[routable].copy(), rng, SEN, BIG,
                local_search_rounds, refine_block, lm_before)
            pchosen[routable] = sub_chosen
        t_refine += time.time() - t0
        table = _rebuild_table(table, pool, pool_hop_idx, plens, kv,
                               cand, vcs, pchosen, SEN)
        # ---- stage C: streamed VC re-allocation over the pool -------------
        t0 = time.time()
        counts = reallocate_vcs(at2, table, pool, counts)
        t_vc += time.time() - t0
        lost2 = pool[~routable_m]
        touched2 = np.union1d(state.touched, pool[routable_m])
    else:
        table = state.table.copy()

    t0 = time.time()
    if verify == "full":
        deadlock_free = verify_deadlock_free(at2, table)
    elif len(pool):
        deadlock_free = verify_flows_deadlock_free(at2, table, pool)
    else:
        deadlock_free = True
    stats["verify_s"] = round(time.time() - t0, 3)

    stats.update({"walk_s": round(t_walk, 3), "bfs_s": round(t_bfs, 3),
                  "greedy_s": round(t_greedy, 3),
                  "refine_s": round(t_refine, 3),
                  "vc_s": round(t_vc, 3), "lost": int(len(lost2))})
    new_state = ServingState(state.topo, at2, table, loads, counts,
                             dead_all, dist_store, best_store, K,
                             state.seed, stats=state.stats, lost=lost2,
                             touched=touched2, at0=state.at0)
    stats["total_s"] = round(time.time() - t_all, 3)
    return RepairResult(new_state, flows_rerouted=len(pool),
                        l_max=float(loads[:SEN].max()),
                        unreachable=unreachable,
                        deadlock_free=bool(deadlock_free),
                        fallback=False, readmitted=readmitted,
                        stats=stats, lost=int(len(lost2)),
                        restored=int(len(revived)), pool_flows=pool)


def full_recompute(state: ServingState, dead_channels=None
                   ) -> Tuple[RoutingResult, np.ndarray, ATResult]:
    """The repair oracle: prune the AT exactly like :func:`repair_fault`
    then re-select and re-allocate *every* flow from scratch in the same
    channel-id space. Returns ``(routed, vc_counts, at2)``; repair
    quality (post-repair ``l_max``) and recovery wall-clock are measured
    against this. Input ids are validated like :func:`repair_fault`."""
    dc = _validated_dead(dead_channels, state.at.channels.n)
    dead_all = np.union1d(state.dead, dc)
    dead_mask = np.zeros(state.at.channels.n, bool)
    dead_mask[dead_all] = True
    at2 = _pruned_at(state.at, dead_mask)
    routed = select_paths(at2, K=state.K, seed=state.seed,
                          engine="sharded", dead_channels=dead_all)
    counts = allocate_vcs(at2, routed.table)
    return routed, counts, at2
