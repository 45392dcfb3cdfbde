"""Deadlock-free routing: allowed turns (AT) on the VC-labeled CDG,
candidate-path enumeration, and min-max-channel-load path selection.

Port of ``repro.core.routing``: numpy on the host, unchanged except that
the APL priority's all-pairs hop matrix (and :func:`load_lower_bound`'s)
comes from the (min,+) APSP kernel on the ``device`` passed through
:func:`allowed_turns`.

Paper Section 5 / Algorithms 1-2. Deadlock freedom is decoupled from route
selection: a greedy allowed-turn construction keeps the channel dependency
graph acyclic (incremental cycle detection); all shortest deadlock-free
paths are enumerated per pair; a min-max load optimisation then picks one
static path per (src, dst). Turn prioritisation: APL / CPL / Random.

Array layout of the routing engine
----------------------------------

The hot path is a packed-array pipeline over *states* ``s = c * n_vc + v``
(channel ``c`` on virtual channel ``v``; ``S = C * n_vc`` states total):

- :class:`StateGraph` compiles ``ATResult.allowed`` once into (a) a CSR
  adjacency used for frontier expansion, (b) a ``(S, D)`` padded reverse
  adjacency (``D`` = max in-degree) for parent walks, and (c) a sorted
  ``a * S + b`` edge-key array for O(log E) membership tests (VC alloc,
  deadlock verification).
- :func:`state_bfs` runs a level-synchronous BFS batched over a block of
  sources: the frontier is a dense ``(B, S)`` boolean, each level is one
  sparse-matrix product with the transposed CSR, and distances land in a
  ``(B, S)`` int16 array (-1 = unreached, seeds at distance 1).
- :func:`enumerate_candidates` turns distances into the packed
  ``(F, K, L)`` candidate tensor (``L`` = longest shortest path, SEN-padded
  channels + per-hop VCs) with a vectorised backward walk over the parent
  DAG: all ``F * K`` walkers step one BFS level per iteration, and each
  walker's mixed-radix "k-code" picks which parent to take so distinct
  codes enumerate distinct shortest paths.
- :func:`select_paths` evaluates the lexicographic ``(l_max, l_sum)`` cost
  of whole flow blocks at once (one gather of channel loads per block) for
  the greedy pass, then runs block-parallel local search with exact
  own-load removal. The per-flow python loops of the seed implementation
  are kept verbatim as ``engine="reference"`` -- the equivalence oracle.

Everything downstream (VC allocation, ``netsim.build_tables``) consumes the
same packed :class:`~repro.core.pathtable.PathTable`; an 8^3 pod (512
chips, ~3k channels) routes end-to-end in seconds.

Batched allowed-turns admission
-------------------------------

Algorithm 1 admits VC-labeled turns one at a time under an incremental
acyclicity check; the seed ran a python Pearce-Kelly insertion per
attempt, which made ``allowed_turns`` the front-end bottleneck past a few
hundred nodes. :class:`_BatchedDAG` replays the same serial greedy in
blocks and produces the *identical* allowed set:

- attempts consistent with a maintained topological numbering
  (``level``) are accepted wholesale -- a batch of forward edges can
  never create a cycle;
- the backward minority goes through one batched BFS over the accepted
  CSR (level-window pruned): already-reachable heads are definite
  rejections (sticky across both VC passes -- reachability only grows),
  the rest are contested;
- one SCC pass over accepted + candidates splits the contested set into
  independent *tangles* (an edge can conflict only with candidates in
  its own strongly connected component); everything untangled commits
  in bulk, and each tangle is replayed through its interaction graph
  (head-reaches-tail bitsets, built by one scatter-OR sweep over the
  component's level bands) with an incremental transitive closure --
  the exact dead-end fallback, still array-backed;
- levels are repaired by a local gap-spaced relaxation confined to the
  raised region.

``at_engine="reference"`` keeps the seed loop as the equivalence oracle
(the produced sets match bit for bit; ``tests/test_at_engine.py``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pathtable import MAXHOP, CSRPathTable, PathTable
from repro_torch.core.topology import Topology


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Channels:
    """Directed channels of an undirected topology.

    Besides the flat ``src``/``dst``/``color`` arrays, carries an
    out-adjacency CSR (``out_indptr``/``out_chan``) and the opposite
    direction of every channel (``rev``), so per-node queries are O(deg)
    slices instead of O(C) boolean scans.
    """
    src: np.ndarray           # (C,)
    dst: np.ndarray           # (C,)
    color: np.ndarray         # OCS color or -1 (electrical)
    index: Dict[Tuple[int, int], int]
    out_indptr: np.ndarray    # (n_nodes + 1,) CSR offsets into out_chan
    out_chan: np.ndarray      # (C,) channel ids grouped by source node
    rev: np.ndarray           # (C,) channel id of the reverse direction

    @staticmethod
    def from_topology(topo: Topology) -> "Channels":
        """Build (or fetch) the channel arrays of ``topo``.

        The result is cached on the topology object (topologies are
        immutable after construction): ``allowed_turns``, the simulator
        table builders and the collectives all start from the same
        ``Channels``, and fault sweeps used to rebuild it from scratch on
        every re-route.
        """
        cached = topo.__dict__.get("_channels")
        if cached is not None:
            return cached
        e = topo.edges()
        col = topo.edge_colors()
        src = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
        dst = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
        color = np.concatenate([col, col]).astype(np.int32)
        index = {(int(s), int(d)): i for i, (s, d) in
                 enumerate(zip(src, dst))}
        order = np.argsort(src, kind="stable").astype(np.int32)
        out_indptr = np.searchsorted(src[order],
                                     np.arange(topo.n + 1)).astype(np.int64)
        E = len(e)
        rev = np.concatenate([np.arange(E, 2 * E), np.arange(E)]) \
            .astype(np.int32)
        out = Channels(src, dst, color, index, out_indptr, order, rev)
        topo.__dict__["_channels"] = out
        return out

    @property
    def n(self) -> int:
        return len(self.src)

    @property
    def n_nodes(self) -> int:
        return len(self.out_indptr) - 1

    def out_of(self, node: int) -> np.ndarray:
        """Channels leaving ``node`` -- an O(deg) CSR slice."""
        return self.out_chan[self.out_indptr[node]:self.out_indptr[node + 1]]


# ---------------------------------------------------------------------------
# Incremental cycle detection (Pearce-Kelly) on the VC-labeled CDG
# ---------------------------------------------------------------------------


class IncrementalDAG:
    """Maintains a topological order under edge insertions; insertions that
    would create a cycle are rejected."""

    def __init__(self, n_nodes: int):
        self.n = n_nodes
        self.order = np.arange(n_nodes, dtype=np.int64)
        self.pos = np.arange(n_nodes, dtype=np.int64)
        self.adj: List[List[int]] = [[] for _ in range(n_nodes)]
        self.radj: List[List[int]] = [[] for _ in range(n_nodes)]

    def try_add(self, u: int, v: int) -> bool:
        if u == v:
            return False
        lb, ub = self.pos[v], self.pos[u]
        if lb > ub:                 # already consistent
            self.adj[u].append(v)
            self.radj[v].append(u)
            return True
        # discover affected region
        visited_f: List[int] = []
        seen_f = {v}
        stack = [v]
        ok = True
        while stack:
            x = stack.pop()
            visited_f.append(x)
            for y in self.adj[x]:
                if y == u:
                    ok = False
                    stack = []
                    break
                if self.pos[y] <= ub and y not in seen_f:
                    seen_f.add(y)
                    stack.append(y)
        if not ok:
            return False
        visited_b: List[int] = []
        seen_b = {u}
        stack = [u]
        while stack:
            x = stack.pop()
            visited_b.append(x)
            for y in self.radj[x]:
                if self.pos[y] >= lb and y not in seen_b:
                    seen_b.add(y)
                    stack.append(y)
        # reorder: backward region then forward region into the merged slots
        region = sorted(visited_b, key=lambda x: self.pos[x]) + \
            sorted(visited_f, key=lambda x: self.pos[x])
        slots = np.sort(self.pos[np.array(region)])
        for node, slot in zip(region, slots):
            self.pos[node] = slot
            self.order[slot] = node
        self.adj[u].append(v)
        self.radj[v].append(u)
        return True


# ---------------------------------------------------------------------------
# State graph: packed CSR over (channel, vc) states
# ---------------------------------------------------------------------------


def _state(c: int, v: int, n_vc: int) -> int:
    return c * n_vc + v


@dataclasses.dataclass
class StateGraph:
    """CSR forms of the allowed-turn DAG over ``c * n_vc + v`` states,
    compiled once per :class:`ATResult` and shared by the batched BFS,
    candidate enumeration and vectorised VC allocation."""
    n_states: int
    n_vc: int
    keys: np.ndarray          # (E,) sorted a * n_states + b edge keys
    fwd_T: object             # scipy CSR of the transposed adjacency
    rev_pad: np.ndarray       # (S, D) int32 parents of each state, -1 pad
    dst_node: np.ndarray      # (S,) arrival node of each state's channel
    node_order: np.ndarray    # (S,) state ids sorted by dst_node
    node_starts: np.ndarray   # (n_nodes + 1,) segment offsets in node_order

    def has_edges(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorised membership test for state edges a -> b."""
        q = a.astype(np.int64) * self.n_states + b.astype(np.int64)
        if len(self.keys) == 0:
            return np.zeros(q.shape, bool)
        i = np.clip(np.searchsorted(self.keys, q), 0, len(self.keys) - 1)
        return self.keys[i] == q


def _build_state_graph(at: "ATResult") -> StateGraph:
    import scipy.sparse as sp
    ch = at.channels
    n_vc = at.n_vc
    S = ch.n * n_vc
    if at._edges is not None:
        a, b = at._edges[:, 0].astype(np.int64), at._edges[:, 1].astype(
            np.int64)
    elif at.allowed:
        ab = np.array([(ci * n_vc + v0, co * n_vc + v1)
                       for ((ci, v0), (co, v1)) in at.allowed], np.int64)
        a, b = ab[:, 0], ab[:, 1]
    else:
        a = b = np.zeros(0, np.int64)
    # canonical edge order: the padded reverse adjacency below decides
    # which parents the candidate walkers see first, so both admission
    # engines (any insertion order) must compile to the same StateGraph
    canon = np.argsort(a * S + b, kind="stable")
    a, b = a[canon], b[canon]
    keys = a * S + b
    adj = sp.csr_matrix((np.ones(len(a), np.float32), (a, b)), shape=(S, S))
    fwd_T = adj.T.tocsr()
    order = np.argsort(b, kind="stable")
    bs, as_ = b[order], a[order]
    deg = np.bincount(bs, minlength=S)
    D = max(int(deg.max()) if len(a) else 0, 1)
    rev_pad = np.full((S, D), -1, np.int32)
    starts = np.searchsorted(bs, np.arange(S))
    rev_pad[bs, np.arange(len(bs)) - starts[bs]] = as_
    dst_node = ch.dst[np.arange(S) // n_vc].astype(np.int64)
    node_order = np.argsort(dst_node, kind="stable")
    node_starts = np.searchsorted(dst_node[node_order],
                                  np.arange(ch.n_nodes + 1))
    return StateGraph(S, n_vc, keys, fwd_T, rev_pad, dst_node,
                      node_order, node_starts)


# ---------------------------------------------------------------------------
# Allowed-turn construction (Algorithms 1 & 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ATResult:
    channels: Channels
    n_vc: int
    allowed: set                       # ((c_in, v0), (c_out, v1))
    trees: List[List[int]]             # robust spanning trees (channel lists)
    stats: Optional[dict] = None       # admission-engine counters
    _sg: Optional[StateGraph] = dataclasses.field(
        default=None, repr=False, compare=False)
    _edges: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)   # (E, 2) state edges
    _by_in: Optional[Dict] = dataclasses.field(
        default=None, repr=False, compare=False)
    _admission: Optional[Dict] = dataclasses.field(
        default=None, repr=False, compare=False)
    # ^ batched-engine admission snapshot (final topological levels, the
    #   (T, n_vo) accepted grid, base turns, VC-order pairs, priority
    #   permutation, per-state slot capacities, cumulative dead-turn
    #   mask). The fault-repair pipeline (repro.core.repair) patches it
    #   in place of replaying the full turn admission.

    def is_allowed(self, cin, v0, cout, v1) -> bool:
        return ((cin, v0), (cout, v1)) in self.allowed

    @property
    def allowed_by_in(self) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
        """Out-turns per (channel, vc) state, built lazily (the reference
        enumerator is the only consumer; the hot path uses
        :meth:`state_graph`). Canonically sorted so both admission engines
        drive the python oracle identically."""
        if self._by_in is None:
            by_in: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
                defaultdict(list)
            for (a, b) in sorted(self.allowed):
                by_in[a].append(b)
            self._by_in = dict(by_in)
        return self._by_in

    def state_graph(self) -> StateGraph:
        """Packed CSR of ``allowed`` (built once, then cached)."""
        if self._sg is None:
            self._sg = _build_state_graph(self)
        return self._sg


def spanning_tree_channels(topo: Topology, ch: Channels, root: int,
                           forbidden_colors: Optional[set] = None,
                           rng=None) -> Tuple[List[int], set]:
    """BFS tree; returns both directions of each tree edge + used colors."""
    n = topo.n
    seen = np.zeros(n, bool)
    seen[root] = True
    q = deque([root])
    chans: List[int] = []
    used_colors: set = set()
    forbidden = forbidden_colors or set()
    while q:
        u = q.popleft()
        outs = ch.out_of(u)
        if rng is not None:
            outs = outs.copy()
            rng.shuffle(outs)
        for c in outs:
            v = int(ch.dst[c])
            if seen[v]:
                continue
            col = int(ch.color[c])
            if col >= 0 and col in forbidden:
                continue
            seen[v] = True
            if col >= 0:
                used_colors.add(col)
            chans.append(int(c))
            chans.append(int(ch.rev[c]))
            q.append(v)
    if not seen.all():
        return [], used_colors
    return chans, used_colors


def ocs_disjoint_spanning_trees(topo: Topology, ch: Channels
                                ) -> Optional[Tuple[List[int], List[int]]]:
    """Two spanning trees using disjoint OCS color sets (electrical edges
    may be shared -- they cannot fault). Concurrent BFS from hop-distance
    antipodes (paper 5.2)."""
    from repro_torch.core.topology import bfs_all_pairs
    d = bfs_all_pairs(topo, sources=np.array([0]))[0]
    far = int(np.argmax(d))
    t0, colors0 = spanning_tree_channels(topo, ch, 0)
    if not t0:
        return None
    t1, colors1 = spanning_tree_channels(topo, ch, far,
                                         forbidden_colors=colors0)
    if not t1:
        # retry with a few random tie-breaks
        rng = np.random.default_rng(0)
        for _ in range(8):
            t0, colors0 = spanning_tree_channels(topo, ch, 0, rng=rng)
            t1, colors1 = spanning_tree_channels(
                topo, ch, far, forbidden_colors=colors0, rng=rng)
            if t1:
                break
    if not t1:
        return None
    return t0, t1


def _tree_turns_array(chans, ch: Channels) -> np.ndarray:
    """All non-reversing turns among a tree's channels, as a ``(K, 2)``
    ``(cin, cout)`` array (the set is acyclic together).

    Vectorised ragged cross-product, order-identical to the seed's dict
    loops (mid nodes by first occurrence as a destination in ``chans``,
    in/out channels in ``chans`` order) -- the emitted order feeds the
    admission sequence, which must match ``at_engine="reference"``.
    """
    A = np.asarray(chans, np.int64)
    if len(A) == 0:
        return np.zeros((0, 2), np.int32)
    dstA = ch.dst[A].astype(np.int64)
    srcA = ch.src[A].astype(np.int64)
    # mid nodes ranked by first occurrence as a dst
    du, di = np.unique(dstA, return_index=True)
    mids = du[np.argsort(di, kind="stable")]
    rank = np.full(ch.n_nodes, -1, np.int64)
    rank[mids] = np.arange(len(mids))
    ins = A[np.argsort(rank[dstA], kind="stable")]        # grouped by mid
    icnt = np.bincount(rank[dstA], minlength=len(mids)).astype(np.int64)
    omask = rank[srcA] >= 0
    osel = A[omask]
    og = rank[srcA[omask]]
    outs = osel[np.argsort(og, kind="stable")]
    ocnt = np.bincount(og, minlength=len(mids)).astype(np.int64)
    # per group g: icnt[g] * ocnt[g] (cin-major) pairs
    cin = np.repeat(ins, np.repeat(ocnt, icnt))
    tot = icnt * ocnt
    if int(tot.sum()) == 0:
        return np.zeros((0, 2), np.int32)
    ostart = np.cumsum(ocnt) - ocnt
    gstart = np.cumsum(tot) - tot
    within = np.arange(int(tot.sum())) - np.repeat(gstart, tot)
    cout = outs[np.repeat(ostart, tot) + within % np.repeat(ocnt, tot)]
    keep = ch.dst[cout] != ch.src[cin]                    # no u-turn
    return np.stack([cin[keep], cout[keep]], axis=1).astype(np.int32)


def _tree_turns(chans: List[int], ch: Channels) -> List[Tuple[int, int]]:
    """List-of-tuples view of :func:`_tree_turns_array` (API edge)."""
    return list(map(tuple, _tree_turns_array(chans, ch).tolist()))


def base_turns_array(ch: Channels) -> np.ndarray:
    """All non-reversing ``(cin, cout)`` turns as a ``(T, 2)`` array.

    One ragged gather over the out-adjacency CSR: for every channel
    ``cin`` the out-channels of its arrival node, minus u-turns. Order is
    ``cin``-major with ``cout`` ascending -- identical to the seed's dict
    loop, so turn-priority permutations line up exactly.
    """
    mid = ch.dst.astype(np.int64)                         # (C,)
    deg = (ch.out_indptr[mid + 1] - ch.out_indptr[mid]).astype(np.int64)
    total = int(deg.sum())
    cin = np.repeat(np.arange(ch.n, dtype=np.int64), deg)
    within = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
    cout = ch.out_chan[ch.out_indptr[mid[cin]] + within].astype(np.int64)
    keep = ch.dst[cout] != ch.src[cin]
    return np.stack([cin[keep], cout[keep]], axis=1).astype(np.int32)


def base_turns(ch: Channels) -> List[Tuple[int, int]]:
    """List-of-tuples view of :func:`base_turns_array` (API edge)."""
    return list(map(tuple, base_turns_array(ch).tolist()))


def _apl_turn_frequencies(t: np.ndarray, topo: Topology,
                          ch: Channels, device=None) -> np.ndarray:
    """APL frequency of each turn in ``t`` ((T, 2) int) over the
    all-shortest-path sets.

    Batched over the BFS level structure: per-source path multiplicities
    come from level-masked sparse matrix products, and each turn's
    frequency is one masked reduction over all sources at once (the
    seed's per-source parent/grandparent triple loop was O(n deg^2)
    python and dominated ``allowed_turns`` beyond ~200 nodes).

    The all-pairs hop matrix comes from the (min,+) APSP kernel on
    ``device`` (see :func:`~repro_torch.core.topology.bfs_all_pairs`).
    """
    import scipy.sparse as sp
    from repro_torch.core.topology import bfs_all_pairs
    n = topo.n
    d = bfs_all_pairs(topo, device=device)        # (n, n) float, inf = cut
    finite = np.isfinite(d)
    maxd = int(d[finite].max()) if finite.any() else 0
    d32 = np.where(finite, d, -2.0).astype(np.float32)
    adj_T = sp.csr_matrix((np.ones(ch.n, np.float32),
                           (ch.dst.astype(np.int64),
                            ch.src.astype(np.int64))), shape=(n, n))
    # npaths[s, v]: shortest-path multiplicities, filled level by level
    npaths = np.zeros((n, n), np.float32)
    npaths[np.arange(n), np.arange(n)] = 1.0
    for lvl in range(1, maxd + 1):
        prev = np.where(d32 == lvl - 1, npaths, np.float32(0.0))
        contrib = adj_T.dot(prev.T).T             # sum over in-neighbors
        npaths = np.where(d32 == lvl, contrib, npaths)
    cin, cout = t[:, 0], t[:, 1]
    gp = ch.src[cin].astype(np.int64)
    mid = ch.dst[cin].astype(np.int64)
    vv = ch.dst[cout].astype(np.int64)
    freq = np.zeros(len(t))
    chunk = max(1, (1 << 24) // max(len(t), 1))
    for s0 in range(0, n, chunk):
        D = d32[s0:s0 + chunk]
        dm = D[:, mid]
        on_dag = (D[:, gp] + 1 == dm) & (dm + 1 == D[:, vv])
        freq += (on_dag * npaths[s0:s0 + chunk][:, gp]).sum(axis=0,
                                                           dtype=np.float64)
    return freq


def prioritize_turns(turns, mode: str, topo: Topology, ch: Channels,
                     seed: int = 0, sym_perms: Optional[np.ndarray] = None,
                     device=None):
    """APL: by frequency over all-shortest-path sets; CPL needs a chosen
    routing (caller re-invokes); Random: shuffled. List API edge over
    :func:`_priority_permutation` (the engines consume the permutation)."""
    rng = np.random.default_rng(seed)
    if mode == "random":
        turns = list(turns)
        rng.shuffle(turns)
        return turns
    turns = list(turns)
    if not turns:
        return turns
    freq = _apl_turn_frequencies(np.asarray(turns, np.int64), topo, ch,
                                 device)
    order = np.argsort(-freq, kind="stable")
    return [turns[i] for i in order]


def _priority_permutation(turns_arr: np.ndarray, priority: str,
                          topo: Topology, ch: Channels, seed: int,
                          chosen_loads: Optional[Dict] = None,
                          device=None) -> np.ndarray:
    """Shared turn ordering of both admission engines, as indices into
    ``turns_arr``. Must replay the seed's list-based ordering exactly:
    stable descending sorts, and ``random`` via a python-list shuffle
    (the Fisher-Yates draw sequence depends only on the length)."""
    T = len(turns_arr)
    if T == 0:
        return np.zeros(0, np.int64)
    if chosen_loads is not None:
        vals = np.fromiter((chosen_loads.get((int(a), int(b)), 0.0)
                            for a, b in turns_arr), np.float64, T)
        return np.argsort(-vals, kind="stable")
    if priority == "random":
        idx = list(range(T))
        np.random.default_rng(seed).shuffle(idx)
        return np.asarray(idx, np.int64)
    freq = _apl_turn_frequencies(turns_arr.astype(np.int64), topo, ch,
                                 device)
    return np.argsort(-freq, kind="stable")


def _vc_order_pairs(n_vc: int) -> np.ndarray:
    """The seed's VC-assignment try order: same-VC diagonals first, then
    the cross assignments in double-loop order. ``(n_vc^2, 2)`` int."""
    vo = [(v, v) for v in range(n_vc)] + \
        [(v0, v1) for v0 in range(n_vc) for v1 in range(n_vc) if v0 != v1]
    return np.asarray(vo, np.int64)


class _BatchedDAG:
    """Array-native incremental-cycle-detection engine for turn admission.

    Replays the serial greedy (one ``IncrementalDAG.try_add`` per
    VC-labeled turn) exactly, but in blocks:

    - ``level`` is a topological numbering of the accepted DAG (every
      edge strictly increases it). Any attempt consistent with it
      (``level[u] < level[v]``) cannot close a cycle, and a whole batch
      of such *forward* edges stays acyclic together -- accepted
      wholesale with no renumbering.
    - Backward attempts are resolved by one batched BFS over the
      accepted out-adjacency (:meth:`reach`), pruned to each row's level
      window: rows whose head already reaches their tail are definite
      rejections (reachability only grows, so the serial run rejects
      them too -- and the rejection is sticky across both VC passes);
      the rest are *contested*.
    - One SCC pass over accepted + candidates (:meth:`_cycle_edges`)
      localises conflicts exactly: a candidate can be invalidated only
      by candidates inside its own non-trivial strongly connected
      component. If no component exists, every candidate is admissible
      at its serial position and the block's winners commit in one
      bulk accept.
    - Otherwise the *tangled* minority is replayed in serial order over
      per-component interaction graphs (:meth:`_h_graph`; a CDG cycle
      alternates candidate edges with pure-G paths, which never leave
      the component) using an incremental bit-packed transitive closure
      -- the exact, still array-native, dead-end fallback. Components
      bigger than ``tangle_cap`` first split the block in half, which
      shrinks them geometrically.
    - Levels are repaired by :meth:`_relax`, a gap-spaced frontier
      relaxation confined to the raised region.

    The out-adjacency is a capacity-preallocated CSR: every candidate
    edge's slot is known from the turn grid ahead of time, so accepting
    a batch is O(batch) array writes and the BFS passes never rebuild
    anything.
    """

    def __init__(self, n_states: int, cap_out: np.ndarray, stats: dict):
        S = int(n_states)
        self.S = S
        self.level = np.zeros(S, np.int64)
        self.cap_start = np.zeros(S + 1, np.int64)
        np.cumsum(cap_out, out=self.cap_start[1:])
        self.buf = np.zeros(int(self.cap_start[-1]), np.int32)
        self.fill = np.zeros(S, np.int64)          # == out-degree
        self.n_edges = 0
        self._log: List[Tuple[np.ndarray, np.ndarray]] = []
        self.gap = 8            # level-raise headroom (see _relax)
        self.tangle_cap = 1024  # biggest tangle resolved without a split
        self.stats = stats

    # -- accepted-graph storage --------------------------------------------

    def accept(self, u: np.ndarray, v: np.ndarray) -> None:
        """Append accepted edges (caller guarantees acyclicity)."""
        if not len(u):
            return
        order = np.argsort(u, kind="stable")
        us, vs = u[order], v[order]
        ku, ui, cnt = np.unique(us, return_index=True, return_counts=True)
        rank = np.arange(len(us)) - np.repeat(ui, cnt)
        self.buf[self.cap_start[us] + self.fill[us] + rank] = vs
        self.fill[ku] += cnt
        self._log.append((us, vs))
        self.n_edges += len(us)

    def _edge_arrays(self):
        """All accepted edges as two flat arrays (log consolidation)."""
        if len(self._log) > 1:
            self._log = [(np.concatenate([e[0] for e in self._log]),
                          np.concatenate([e[1] for e in self._log]))]
        if not self._log:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return self._log[0]

    def _expand(self, states: np.ndarray):
        """Out-neighbors of ``states``: (index-into-states, neighbor)."""
        cnt = self.fill[states]
        total = int(cnt.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        rep = np.repeat(np.arange(len(states)), cnt)
        inner = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        nbr = self.buf[self.cap_start[states[rep]] + inner].astype(np.int64)
        return rep, nbr

    # -- batched reachability ----------------------------------------------

    def reach(self, src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
        """``out[i]`` = can ``src[i]`` reach ``tgt[i]`` in the accepted
        DAG. Frontier BFS batched over rows, each pruned to its own
        level window: any path into ``tgt`` stays strictly below the
        target's level, so most windows are a handful of states."""
        B = len(src)
        reached = np.zeros(B, bool)
        if B == 0 or self.n_edges == 0:
            return reached
        self.stats["bfs_rows"] += B
        S = self.S
        CH = 1024
        for i in range(0, B, CH):
            s, t = src[i:i + CH], tgt[i:i + CH]
            b = len(s)
            cap = self.level[t]
            visited = np.zeros((b, S), bool)
            rows = np.arange(b)
            cur = s.astype(np.int64)
            visited[rows, cur] = True
            got = np.zeros(b, bool)
            while len(rows):
                rep, nbr = self._expand(cur)
                r2 = rows[rep]
                hit = nbr == t[r2]
                if hit.any():
                    got[r2[hit]] = True
                keep = ~hit & ~got[r2] & (self.level[nbr] < cap[r2]) & \
                    ~visited[r2, nbr]
                r2, nbr = r2[keep], nbr[keep]
                if len(r2):
                    _, first = np.unique(r2 * S + nbr, return_index=True)
                    r2, nbr = r2[first], nbr[first]
                    visited[r2, nbr] = True
                rows, cur = r2, nbr
            reached[i:i + b] = got
        return reached

    def commit(self, eu: np.ndarray, ev: np.ndarray,
               n_backward: int) -> None:
        """Accept a verified-acyclic batch, relaxing levels first when
        it contains backward edges (forward-only batches keep the
        current numbering valid as-is)."""
        if n_backward:
            lv = self._relax(eu, ev)
            assert lv is not None, "committed batches are acyclic"
            self.level = lv
        self.accept(eu, ev)

    # -- bulk commit (local level relaxation) ------------------------------

    def _relax(self, bu: np.ndarray, bv: np.ndarray
               ) -> Optional[np.ndarray]:
        """Raise a copy of ``level`` until every accepted + batch edge
        strictly increases it, touching only the affected region (the
        descendants of raised batch heads). The ``gap`` headroom above
        the strict minimum means most future raises land below their
        descendants and stop immediately. Returns the new levels, or
        ``None`` when a level exceeds the acyclic bound (certain
        cycle -- callers only pass verified-acyclic batches, so this
        is an internal invariant check)."""
        GAP = np.int64(self.gap)              # headroom absorbs future
        lv = self.level.copy()                # raises, cutting cascades
        if not len(bu):
            return lv
        bound = int(lv.max()) + (self.S + 1) * int(GAP)
        order = np.argsort(bu, kind="stable")
        sbu, sbv = bu[order], bv[order]
        cur, val = sbv, lv[sbu] + GAP
        keep = val > lv[cur]
        cur, val = cur[keep], val[keep]
        while len(cur):
            if len(cur) > 1:                  # per-node max proposal
                o = np.lexsort((-val, cur))
                cur, val = cur[o], val[o]
                first = np.ones(len(cur), bool)
                first[1:] = cur[1:] != cur[:-1]
                cur, val = cur[first], val[first]
            lv[cur] = val
            if int(val.max()) > bound:
                return None
            rep, nbr = self._expand(cur)
            nv = lv[cur[rep]] + GAP
            lo = np.searchsorted(sbu, cur)    # batch out-edges of cur
            cnt2 = np.searchsorted(sbu, cur, side="right") - lo
            if cnt2.any():
                rep2 = np.repeat(np.arange(len(cur)), cnt2)
                inner = np.arange(int(cnt2.sum())) - \
                    np.repeat(np.cumsum(cnt2) - cnt2, cnt2)
                nbr = np.concatenate([nbr, sbv[lo[rep2] + inner]])
                nv = np.concatenate([nv, lv[cur[rep2]] + GAP])
            keep = nv > lv[nbr]
            cur, val = nbr[keep], nv[keep]
        return lv

    def _cycle_edges(self, bu: np.ndarray, bv: np.ndarray):
        """``out[k]`` = batch edge k lies on some cycle of accepted +
        batch; also returns the per-node SCC labels. Exact: an edge is
        on a cycle iff its endpoints share a non-trivial strongly
        connected component of the union."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components
        gu, gv = self._edge_arrays()
        rows = np.concatenate([gu, bu])
        cols = np.concatenate([gv, bv])
        m = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                          shape=(self.S, self.S))
        ncomp, labels = connected_components(m, directed=True,
                                             connection="strong")
        sizes = np.bincount(labels, minlength=ncomp)
        return (labels[bu] == labels[bv]) & (sizes[labels[bu]] > 1), labels


    # -- tangle interaction graphs -----------------------------------------

    def _h_graph(self, members: np.ndarray, srcs: np.ndarray,
                 tails: np.ndarray):
        """Interaction bitsets of one conflict component: bit ``j`` of
        ``hout[i]`` iff ``srcs[i]`` reaches ``tails[j]`` through the
        accepted DAG (the empty path counts: ``srcs[i] == tails[j]``).
        A union-cycle's pure-G segments never leave its strongly
        connected component, so reachability is computed inside the
        member subgraph only -- and since the accepted graph is a DAG,
        one scatter-OR sweep over its level bands (reverse topological
        order) closes all tail bitsets at once, with no per-source
        BFS."""
        m, c = len(members), len(srcs)
        W = (c + 63) // 64
        comp = np.full(self.S, -1, np.int64)
        comp[members] = np.arange(m)
        word = (np.arange(c) >> 6).astype(np.int64)
        bit = np.uint64(1) << (np.arange(c) & 63).astype(np.uint64)
        R = np.zeros((m, W), np.uint64)       # tails reachable from node
        ct = comp[tails]
        np.bitwise_or.at(R, (ct, word), bit)  # a tail reaches itself
        gu, gv = self._edge_arrays()
        eu, ev = comp[gu], comp[gv]
        keep = (eu >= 0) & (ev >= 0)
        eu, ev = eu[keep], ev[keep]
        if len(eu):
            lv = self.level[members[ev]]
            order = np.argsort(-lv, kind="stable")
            eu, ev, lv = eu[order], ev[order], lv[order]
            bands = np.nonzero(np.diff(lv))[0] + 1
            for lo, hi in zip(np.r_[0, bands], np.r_[bands, len(eu)]):
                np.bitwise_or.at(R, eu[lo:hi], R[ev[lo:hi]])
        hout = R[comp[srcs]]
        # no self interactions (reachability back to the own tail was
        # ruled out by the classification BFS)
        hout[np.arange(c), word] &= ~bit
        bools = np.unpackbits(hout.view(np.uint8), axis=1,
                              bitorder="little")[:, :c].astype(bool)
        packed = np.packbits(bools.T, axis=1, bitorder="little")
        hin = np.zeros((c, W * 8), np.uint8)
        hin[:, :packed.shape[1]] = packed
        return hout, hin.view(np.uint64)

    # -- exact grid admission ----------------------------------------------

    def admit_grid(self, u: np.ndarray, v: np.ndarray, skip: np.ndarray,
                   rej: np.ndarray, first_only: bool):
        """Admit a ``(B, n_vo)`` grid of VC-labeled attempts in serial
        (row-major) order; ``skip`` marks already-allowed edges (trivial
        successes), ``rej`` previously confirmed rejections (sticky --
        reachability only grows). Returns the newly accepted and newly
        rejected grid masks; the result is identical to per-attempt
        serial admission. ``first_only`` replays pass 1 of Algorithm 1,
        where each row stops at its first success.

        One pass per block: the forward test plus one batched BFS
        classifies every attempt into forward / rejected / contested;
        one SCC pass over accepted + candidates localises the conflict
        tangles exactly (an edge is on a union cycle iff its endpoints
        share a non-trivial component). Untangled candidates commit
        wholesale -- nothing can invalidate them. For each tangle the
        interaction graph H (head-reaches-tail through the accepted
        DAG, confined to the component -- a CDG cycle alternates
        candidate edges with pure-G paths, which is exactly an
        H-cycle) comes from :meth:`_h_graph`, and the serial greedy is
        replayed over it with an incremental bit-packed transitive
        closure: rejects are one bitset AND, accepts one vectorized
        ancestor scan. All accepted edges then land in one bulk accept
        + level repair. Components larger than ``tangle_cap`` halve
        the block instead (sequential halves stay exact and tangles
        shrink geometrically with block size)."""
        B, n_vo = u.shape
        acc = np.zeros((B, n_vo), bool)
        new_rej = np.zeros((B, n_vo), bool)
        undecided = ~skip & ~rej
        fwd = np.zeros_like(undecided)
        ur, uc = np.nonzero(undecided)
        fwd[ur, uc] = self.level[u[ur, uc]] < self.level[v[ur, uc]]
        need = undecided & ~fwd
        contested = np.zeros_like(need)
        nr, nc = np.nonzero(need)
        if len(nr):
            reached = self.reach(v[nr, nc], u[nr, nc])
            contested[nr, nc] = ~reached
            new_rej[nr, nc] = reached
        cand = fwd | contested
        if not cand.any():
            return acc, new_rej
        cr, cc = np.nonzero(cand)             # row-major == serial order
        cu, cv = u[cr, cc], v[cr, cc]
        dirty = np.zeros(len(cr), bool)
        if contested[cr, cc].any():
            self.stats["scc_checks"] += 1
            dirty, labels = self._cycle_edges(cu, cv)
        if not dirty.any():
            if first_only:                    # winner = first success col
                okg = skip | cand
                rows = np.nonzero(okg.any(axis=1))[0]
                wcol = okg.argmax(axis=1)[rows]
                keep = ~skip[rows, wcol]
                erow, ecol = rows[keep], wcol[keep]
            else:
                erow, ecol = cr, cc
            eu, ev = u[erow, ecol], v[erow, ecol]
            n_cont = int(contested[erow, ecol].sum())
            self.commit(eu, ev, n_cont)
            acc[erow, ecol] = True
            self.stats["contested_bulk"] += n_cont
            self.stats["fwd_bulk"] += len(eu) - n_cont
            return acc, new_rej
        # tangled block: build the interaction bitsets per conflict
        # component, then replay the serial decisions over a transitively
        # closed "reaches-which-accepted" bitset per attempt
        self.stats["conflict_rounds"] += 1
        c = len(cr)
        dk = np.nonzero(dirty)[0]
        glab = labels[cu[dk]]
        _, gcounts = np.unique(glab, return_counts=True)
        if B > 1 and int(gcounts.max()) > self.tangle_cap:
            # a tangle this big makes the closure quadratic: halve the
            # block (sequential halves stay exact; the sticky rejections
            # discovered above carry over, so no reachability is redone)
            mid = B // 2
            half_rej = rej | new_rej
            a1, r1 = self.admit_grid(u[:mid], v[:mid], skip[:mid],
                                     half_rej[:mid], first_only)
            acc[:mid] |= a1
            new_rej[:mid] |= r1
            a2, r2 = self.admit_grid(u[mid:], v[mid:], skip[mid:],
                                     half_rej[mid:], first_only)
            acc[mid:] |= a2
            new_rej[mid:] |= r2
            return acc, new_rej
        grp_of = np.full(c, -1, np.int64)     # cand idx -> group id
        loc_of = np.full(c, -1, np.int64)     # cand idx -> group-local idx
        groups = []
        for g, lab in enumerate(np.unique(glab)):
            idx = dk[glab == lab]
            grp_of[idx] = g
            loc_of[idx] = np.arange(len(idx))
            members = np.nonzero(labels == lab)[0]
            hout, hin = self._h_graph(members, cv[idx], cu[idx])
            ct = len(idx)
            Wt = hout.shape[1]
            groups.append({
                "hout": hout, "hin": hin,
                "word": (np.arange(ct) >> 6).astype(np.int64),
                "bit": np.uint64(1) << (np.arange(ct) & 63).astype(
                    np.uint64),
                "D": np.zeros((ct, Wt), np.uint64),  # reachable accepted
                "flag_w": np.zeros(Wt, np.uint64),
            })
        commit = np.zeros(c, bool)

        def try_insert(k: int) -> bool:
            """Insert attempt k into its component's accepted subgraph
            unless that closes an H-cycle (== a CDG cycle through k): the
            accepted attempts reachable from k must avoid its accepted
            in-neighbors. ``D`` rows are transitively closed, so the
            test is one bitset AND; an accept updates the closure with
            one vectorized ancestor scan."""
            G = groups[grp_of[k]]
            p = int(loc_of[k])
            inw = G["hin"][p] & G["flag_w"]
            D = G["D"]
            if (D[p] & inw).any():
                return False
            pw, pb = G["word"][p], G["bit"][p]
            anc = ((G["hout"][:, pw] & pb) != 0) | \
                (D & inw[None, :]).any(axis=1)
            newbits = D[p].copy()
            newbits[pw] |= pb
            ai = np.nonzero(anc)[0]
            if len(ai):                       # everything reaching p
                D[ai] |= newbits              # inherits its closure
            G["flag_w"][pw] |= pb
            return True

        kgrid = np.full((B, n_vo), -1, np.int64)
        kgrid[cr, cc] = np.arange(len(cr))
        if first_only:
            rlist = np.nonzero(cand.any(axis=1) | skip.any(axis=1))[0]
        else:
            rlist = np.nonzero(cand.any(axis=1))[0]
        for r in rlist.tolist():
            for j in range(n_vo):
                if skip[r, j]:
                    if first_only:
                        break
                    continue
                k = kgrid[r, j]
                if k < 0:
                    continue                  # rejected or not undecided
                k = int(k)
                if not dirty[k] or try_insert(k):
                    commit[k] = True
                else:
                    new_rej[r, j] = True
                    continue
                if first_only:
                    break
        eu, ev = cu[commit], cv[commit]
        n_cont = int(contested[cr[commit], cc[commit]].sum())
        self.commit(eu, ev, n_cont)
        acc[cr[commit], cc[commit]] = True
        nd = commit & ~dirty
        nd_cont = int(contested[cr[nd], cc[nd]].sum())
        self.stats["tangle_commits"] += int((commit & dirty).sum())
        self.stats["contested_bulk"] += nd_cont
        self.stats["fwd_bulk"] += int(nd.sum()) - nd_cont
        return acc, new_rej


def _allowed_turns_batched(topo: Topology, n_vc: int, priority: str,
                           robust: bool, seed: int,
                           chosen_loads: Optional[Dict],
                           block: int = 1024, device=None) -> ATResult:
    """Algorithm 1 via the batched admission engine (see
    :class:`_BatchedDAG`); produces the exact allowed set of
    ``at_engine="reference"``."""
    ch = Channels.from_topology(topo)
    S = ch.n * n_vc
    turns = base_turns_array(ch)                      # (T, 2)
    T = len(turns)
    vo = _vc_order_pairs(n_vc)                        # (n_vo, 2)
    n_vo = len(vo)
    cin = turns[:, 0].astype(np.int64)
    cout = turns[:, 1].astype(np.int64)
    U = cin[:, None] * n_vc + vo[None, :, 0]          # (T, n_vo) tails
    V = cout[:, None] * n_vc + vo[None, :, 1]         # (T, n_vo) heads
    # per-state slot capacity = candidate attempts with that tail state:
    # every possible edge has a reserved CSR slot
    cap_out = np.repeat(np.bincount(cin, minlength=ch.n), n_vc) * n_vc
    stats = {"blocks": 0, "fwd_bulk": 0, "contested_bulk": 0,
             "bfs_rows": 0, "scc_checks": 0, "conflict_rounds": 0,
             "tangle_commits": 0, "admitted_per_block": []}
    eng = _BatchedDAG(S, cap_out, stats)
    acc = np.zeros((T, n_vo), bool)                   # == the allowed set
    rej = np.zeros((T, n_vo), bool)                   # sticky rejections
    keys = cin * ch.n + cout                          # ascending by build
    trees: List[List[int]] = []

    def admit_block(b: np.ndarray, j: slice, first_only: bool) -> None:
        res, res_rej = eng.admit_grid(U[b, j], V[b, j], acc[b, j],
                                      rej[b, j], first_only)
        acc[b, j] |= res
        rej[b, j] |= res_rej
        stats["blocks"] += 1
        stats["admitted_per_block"].append(int(res.sum()))

    def admit_stream(tt: np.ndarray, vc: int) -> None:
        """Seeding stream: same-VC turns admitted in sequence (each its
        own group, like the serial add_turn loop)."""
        if not len(tt):
            return
        ti = np.searchsorted(keys, tt[:, 0].astype(np.int64) * ch.n
                             + tt[:, 1])
        j = slice(int(vc), int(vc) + 1)               # diagonal (vc, vc)
        for i in range(0, len(ti), block):
            admit_block(ti[i:i + block], j, first_only=False)

    if robust:
        pair = ocs_disjoint_spanning_trees(topo, ch)
        if pair is not None:
            for vc, tree in zip((0, min(1, n_vc - 1)), pair):
                trees.append(tree)
                admit_stream(_tree_turns_array(tree, ch), vc)

    # routability seed: spanning tree on VC0 (Alg. 1 lines 9-10)
    t0, _ = spanning_tree_channels(topo, ch, 0)
    admit_stream(_tree_turns_array(t0, ch), 0)

    perm = _priority_permutation(turns, priority, topo, ch, seed,
                                 chosen_loads, device)
    # pass 1 (first success per turn), then pass 2 (every admissible VC
    # assignment), in per-VC-layer block admissions
    for first_only in (True, False):
        for i in range(0, T, block):
            admit_block(perm[i:i + block], slice(None), first_only)

    tr, tv = np.nonzero(acc)
    edges = np.stack([U[tr, tv], V[tr, tv]], axis=1)
    allowed = set(zip(zip(cin[tr].tolist(), vo[tv, 0].tolist()),
                      zip(cout[tr].tolist(), vo[tv, 1].tolist())))
    stats["allowed"] = len(allowed)
    stats["engine"] = "batched"
    admission = {"level": eng.level, "acc": acc, "turns": turns, "vo": vo,
                 "perm": perm, "cap_out": cap_out,
                 "dead_turn": np.zeros(T, bool)}
    return ATResult(ch, n_vc, allowed, trees, stats=stats, _edges=edges,
                    _admission=admission)


def _allowed_turns_reference(topo: Topology, n_vc: int, priority: str,
                             robust: bool, seed: int,
                             chosen_loads: Optional[Dict],
                             device=None) -> ATResult:
    """The seed implementation: one python Pearce-Kelly insertion per
    VC-labeled turn. Kept as the equivalence oracle of the batched
    engine (identical allowed set, bit for bit)."""
    ch = Channels.from_topology(topo)
    n_states = ch.n * n_vc
    dag = IncrementalDAG(n_states)
    allowed: set = set()
    trees: List[List[int]] = []

    def add_turn(cin, v0, cout, v1) -> bool:
        key = ((cin, v0), (cout, v1))
        if key in allowed:
            return True
        if dag.try_add(_state(cin, v0, n_vc), _state(cout, v1, n_vc)):
            allowed.add(key)
            return True
        return False

    if robust:
        pair = ocs_disjoint_spanning_trees(topo, ch)
        if pair is not None:
            for vc, tree in zip((0, min(1, n_vc - 1)), pair):
                trees.append(tree)
                for (cin, cout) in _tree_turns(tree, ch):
                    add_turn(cin, vc, cout, vc)

    # routability seed: spanning tree on VC0 (Alg. 1 lines 9-10)
    t0, _ = spanning_tree_channels(topo, ch, 0)
    for (cin, cout) in _tree_turns(t0, ch):
        add_turn(cin, 0, cout, 0)

    turns_arr = base_turns_array(ch)
    perm = _priority_permutation(turns_arr, priority, topo, ch, seed,
                                 chosen_loads, device)
    turns = [(int(a), int(b)) for a, b in turns_arr[perm]]

    vc_orders = [tuple(p) for p in _vc_order_pairs(n_vc).tolist()]
    # first pass: at most one VC-labeled instance per base turn
    for (cin, cout) in turns:
        for (v0, v1) in vc_orders:
            if add_turn(cin, v0, cout, v1):
                break
    # second pass: all admissible VC assignments
    for (cin, cout) in turns:
        for (v0, v1) in vc_orders:
            add_turn(cin, v0, cout, v1)

    return ATResult(ch, n_vc, allowed, trees,
                    stats={"engine": "reference"})


def allowed_turns(topo: Topology, n_vc: int = 2, priority: str = "apl",
                  robust: bool = False, seed: int = 0,
                  chosen_loads: Optional[Dict[Tuple[int, int], float]] = None,
                  at_engine: str = "batched", device=None) -> ATResult:
    """Algorithm 1. ``chosen_loads`` (turn -> frequency in a chosen routing)
    enables the CPL variant on a second invocation.

    ``at_engine="batched"`` (default) runs the array-native admission
    engine -- forward-edge blocks accepted wholesale against the current
    topological order, batched BFS over the accepted CSR for the
    contested backward minority, Kahn bulk commits with bisection
    fallback. ``at_engine="reference"`` is the seed's serial
    Pearce-Kelly loop; both produce the identical allowed set.

    ``device`` (``None`` = CUDA) is where the APL priority's all-pairs
    hop matrix is computed; it raises when no GPU is present.
    """
    if at_engine == "reference":
        return _allowed_turns_reference(topo, n_vc, priority, robust, seed,
                                        chosen_loads, device=device)
    if at_engine != "batched":
        raise ValueError(f"unknown at_engine {at_engine!r}")
    return _allowed_turns_batched(topo, n_vc, priority, robust, seed,
                                  chosen_loads, device=device)


def _dead_channel_array(dead_channels) -> Optional[np.ndarray]:
    """Normalise a dead-channel collection (python set, list, or int
    array -- :func:`repro.core.fault.dead_channels_for_color` returns a
    sorted array) to a sorted int64 array, or ``None`` when empty."""
    if dead_channels is None:
        return None
    if isinstance(dead_channels, np.ndarray):
        dc = dead_channels.astype(np.int64, copy=False)
    else:
        dc = np.fromiter(dead_channels, np.int64, len(dead_channels))
    if not len(dc):
        return None
    return np.unique(dc)


# ---------------------------------------------------------------------------
# Minimal-alternate export for the adaptive simulator kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaptiveRouteTable:
    """Per-(node, destination) minimal next-hop alternates, packed for the
    adaptive netsim kernel.

    The candidate enumerator walks exactly these minimal parents when it
    builds the (F, K, L) path tensor, then keeps only the K winning
    chains; this exports what it throws away, collapsed to the per-hop
    decision the simulator needs: from node ``u`` toward destination
    ``d``, bit ``j`` of ``minmask[u, d]`` says whether the ``j``-th
    outgoing channel of ``u`` (``outch[u, j]``) lies on *some* minimal
    path (``dist[dst(c), d] == dist[u, d] - 1`` over surviving
    channels). A packet holding the table can therefore pick among every
    minimal alternate by live downstream occupancy instead of replaying
    one frozen choice. Distances are plain channel-hop BFS (VC-free):
    the adaptive VCs place no turn restriction -- deadlock freedom comes
    from the reserved escape sub-network, not from the adaptive lanes.
    """
    n: int
    outch: np.ndarray       # (n, D) int32 out-channels per node, -1 pad
    minmask: np.ndarray     # (n, n) uint8: bit j <=> outch[u, j] minimal
    dist: np.ndarray        # (n, n) int16 surviving hop distance, -1 pad

    @property
    def D(self) -> int:
        return self.outch.shape[1]


def adaptive_route(topo: Topology, dead_channels=None
                   ) -> AdaptiveRouteTable:
    """Build the minimal-alternate table over the surviving channels.

    ``outch`` slots are fixed by the topology (CSR out-adjacency order),
    independent of the fault set, so a pre-fault and a post-fault table
    share slot indexing and the kernel can swap ``minmask`` mid-sweep
    without re-indexing queues. Dead channels simply never set their
    minimal bit (and contribute no edge to the distance field).
    """
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    ch = Channels.from_topology(topo)
    n = ch.n_nodes
    dc = _dead_channel_array(dead_channels)
    alive = np.ones(ch.n, bool)
    if dc is not None:
        if (dc < 0).any() or (dc >= ch.n).any():
            bad = dc[(dc < 0) | (dc >= ch.n)]
            raise ValueError(f"unknown channel ids {bad.tolist()} "
                             f"(topology has {ch.n} channels)")
        alive[dc] = False
    deg = np.diff(ch.out_indptr).astype(np.int64)
    D = int(deg.max()) if n else 1
    if D > 8:
        raise ValueError(f"adaptive minmask packs at most 8 out-channels "
                         f"per node (got degree {D})")
    outch = np.full((n, D), -1, np.int32)
    slot = np.arange(int(deg.sum()), dtype=np.int64) \
        - np.repeat(ch.out_indptr[:-1].astype(np.int64), deg)
    outch[np.repeat(np.arange(n), deg), slot] = ch.out_chan
    a = sp.csr_matrix((np.ones(int(alive.sum()), np.float32),
                       (ch.src[alive], ch.dst[alive])), shape=(n, n))
    d = csg.shortest_path(a, method="D", unweighted=True)
    dist = np.where(np.isinf(d), -1, d).astype(np.int16)
    minmask = np.zeros((n, n), np.uint8)
    for j in range(D):
        c = outch[:, j]
        ok = (c >= 0) & alive[np.clip(c, 0, ch.n - 1)]
        nd = ch.dst[np.clip(c, 0, ch.n - 1)].astype(np.int64)
        # (n, n): hop u -> dst(c) is on a minimal path toward every d
        # with dist[u, d] == dist[dst(c), d] + 1 (both sides reachable)
        dn = dist[nd]
        cond = ok[:, None] & (dn >= 0) & (dist == dn + 1)
        minmask |= (cond.astype(np.uint8) << j)
    return AdaptiveRouteTable(n, outch, minmask, dist)


# ---------------------------------------------------------------------------
# Reference enumerator (per-source python BFS) -- kept as the equivalence
# oracle for the array engine below; not on the hot path.
# ---------------------------------------------------------------------------


def shortest_path_states(at: ATResult, source: int,
                         dead_channels: Optional[set] = None):
    """BFS over (channel, vc) states from `source`; returns dist + parents
    per state and best distance per destination node. Reference oracle."""
    n_vc = at.n_vc
    dc = _dead_channel_array(dead_channels)
    dead = set() if dc is None else set(dc.tolist())
    dist: Dict[Tuple[int, int], int] = {}
    parents: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
    q = deque()
    for c in at.channels.out_of(source):
        c = int(c)
        if c in dead:
            continue
        for v in range(n_vc):
            st = (c, v)
            if st not in dist:
                dist[st] = 1
                q.append(st)
    while q:
        st = q.popleft()
        for (c2, v2) in at.allowed_by_in.get(st, []):
            if c2 in dead:
                continue
            st2 = (c2, v2)
            if st2 not in dist:
                dist[st2] = dist[st] + 1
                parents[st2].append(st)
                q.append(st2)
            elif dist[st2] == dist[st] + 1:
                parents[st2].append(st)
    return dist, parents


def candidate_paths(at: ATResult, source: int, K: int = 8,
                    dead_channels: Optional[set] = None
                    ) -> Dict[int, List[Tuple[int, ...]]]:
    """Up to K shortest deadlock-free channel-paths per destination.
    Reference oracle (per-source python DFS over the parent DAG)."""
    ch = at.channels
    dist, parents = shortest_path_states(at, source, dead_channels)
    best: Dict[int, int] = {}
    endstates: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for (c, v), d in dist.items():
        node = int(ch.dst[c])
        if node == source:
            continue
        if node not in best or d < best[node]:
            best[node] = d
            endstates[node] = [(c, v)]
        elif d == best[node]:
            endstates[node].append((c, v))
    out: Dict[int, List[Tuple[int, ...]]] = {}
    for dest, sts in endstates.items():
        paths = []
        seen = set()
        stack = [(st, (st[0],)) for st in sts]
        while stack and len(paths) < K * 3:
            st, suffix = stack.pop()
            if dist[st] == 1:
                if suffix not in seen:
                    seen.add(suffix)
                    paths.append(suffix)
                continue
            for p in parents[st]:
                stack.append((p, (p[0],) + suffix))
        uniq = []
        useen = set()
        for p in paths:
            if p not in useen:
                useen.add(p)
                uniq.append(p)
            if len(uniq) >= K:
                break
        out[dest] = uniq
    return out


# ---------------------------------------------------------------------------
# Array engine: batched frontier BFS + packed candidate enumeration
# ---------------------------------------------------------------------------


def state_bfs(at: ATResult, sources: Sequence[int],
              dead_channels: Optional[set] = None) -> np.ndarray:
    """Level-synchronous BFS over (channel, vc) states, batched over
    ``sources``. Returns ``(B, S)`` int16 distances (-1 = unreached; the
    out-channels of each source seed at distance 1)."""
    sg = at.state_graph()
    ch = at.channels
    S, n_vc = sg.n_states, at.n_vc
    sources = np.asarray(sources, np.int64)
    B = len(sources)
    dead_state = np.zeros(S, bool)
    dc = _dead_channel_array(dead_channels)
    if dc is not None:
        dead_state[(dc[:, None] * n_vc + np.arange(n_vc)).ravel()] = True
    dist = np.full((B, S), -1, np.int16)
    frontier = np.zeros((B, S), bool)
    deg = (ch.out_indptr[sources + 1] - ch.out_indptr[sources]).astype(int)
    rows = np.repeat(np.arange(B), deg * n_vc)
    seed_ch = np.concatenate(
        [ch.out_of(int(s)) for s in sources]) if B else np.zeros(0, int)
    seed_st = (seed_ch.astype(np.int64)[:, None] * n_vc
               + np.arange(n_vc)).ravel()
    frontier[rows, seed_st] = True
    frontier &= ~dead_state
    level = 1
    while frontier.any():
        dist[frontier] = level
        nxt = sg.fwd_T.dot(frontier.T.astype(np.float32)) > 0
        frontier = nxt.T & (dist < 0) & ~dead_state
        level += 1
        if level > S:                        # defensive: cannot recur
            break
    return dist


def node_distances(at: ATResult, sources: Sequence[int],
                   dead_channels: Optional[set] = None,
                   dist: Optional[np.ndarray] = None) -> np.ndarray:
    """``(B, n)`` shortest deadlock-free hop distance from each source to
    every node: min over that node's arrival states. -1 = unreachable,
    0 = self. Matches the reference enumerator's distances exactly."""
    sg = at.state_graph()
    if dist is None:
        dist = state_bfs(at, sources, dead_channels)
    B = dist.shape[0]
    UNREACH = np.int32(sg.n_states + 1)
    dd = np.where(dist < 0, UNREACH, dist.astype(np.int32))[:, sg.node_order]
    best = np.minimum.reduceat(dd, sg.node_starts[:-1], axis=1)
    empty = sg.node_starts[:-1] == sg.node_starts[1:]
    best[:, empty] = UNREACH
    best = np.where(best >= UNREACH, -1, best)
    best[np.arange(B), np.asarray(sources, np.int64)] = 0
    return best


@dataclasses.dataclass
class CandidateSet:
    """Packed shortest-path candidates: ``chan``/``vc`` are ``(F, K, L)``
    (``L`` = longest shortest path this round; channels SEN-padded with
    ``n_ch``), ``length[f]`` is every candidate's hop count (all candidates
    of a flow are shortest), ``k_valid`` masks deduplicated slots."""
    flow_src: np.ndarray
    flow_dst: np.ndarray
    chan: np.ndarray
    vc: np.ndarray
    length: np.ndarray
    k_valid: np.ndarray
    n_ch: int
    unreachable: int


def _unique_channel_flows(sg: StateGraph, dist: np.ndarray,
                          best: np.ndarray, n: int) -> np.ndarray:
    """(B, n) bool: flows whose BFS distance field admits a *single
    shortest channel path* (every shortest state path projects onto the
    same channel sequence, whatever its VC labeling). Such flows get a
    one-walker budget and skip the mixed-radix slot machinery in
    :func:`_walk_flows` (the ``kcap=1`` fast lane): all their candidates
    would use the same channels, so the min-max greedy could never
    distinguish them anyway -- and ties break to slot 0, the slot the
    single walker produces.

    Forward DP over the BFS levels: each state carries a flag ("all
    shortest state paths to me share one channel projection") plus the
    64-bit polynomial hash of that canonical projection; a state stays
    unique iff every valid parent is unique with the *same* projection
    hash. A flow is unique iff its arrival states at the best distance
    all agree likewise. (Hash collisions could flag a two-path flow as
    unique -- same 2^-64 risk the walk's dedup hash already accepts; the
    consequence is a valid-but-unoptimised path choice, never an invalid
    route.) Costs one sort of the reached states plus one ``rev_pad``
    gather per level -- the same access pattern as a single extra
    walker, amortised over the whole shard.
    """
    B, S = dist.shape
    mul = np.uint64(0x9E3779B97F4A7C15)
    st_chan = (np.arange(S, dtype=np.uint64) // np.uint64(sg.n_vc)
               + np.uint64(1))
    ucp = np.zeros((B, S), np.uint8)       # 0 unreached, 1 unique, 2 multi
    hproj = np.zeros((B, S), np.uint64)
    m1 = dist == 1
    ucp[m1] = 1
    hproj[m1] = np.broadcast_to(st_chan, (B, S))[m1]
    bb, vv = np.nonzero(dist >= 2)
    if len(bb):
        lv = dist[bb, vv].astype(np.int64)
        order = np.argsort(lv, kind="stable")
        bb, vv, lv = bb[order], vv[order], lv[order]
        lmax = int(lv[-1])
        starts = np.searchsorted(lv, np.arange(2, lmax + 2))
        for l in range(2, lmax + 1):
            a, b = starts[l - 2], starts[l - 1]
            if a == b:
                continue
            rb, rv = bb[a:b], vv[a:b]
            par = sg.rev_pad[rv].astype(np.int64)
            pc = np.clip(par, 0, S - 1)
            okp = (par >= 0) & (dist[rb[:, None], pc] == l - 1)
            pu = ucp[rb[:, None], pc]
            ph = hproj[rb[:, None], pc]
            ref = ph[np.arange(len(rv)), okp.argmax(axis=1)]
            u = (((pu == 1) | ~okp).all(axis=1)
                 & (np.where(okp, ph, ref[:, None])
                    == ref[:, None]).all(axis=1))
            ucp[rb, rv] = np.where(u, 1, 2).astype(np.uint8)
            hproj[rb, rv] = np.where(u, ref * mul + st_chan[rv], 0)
    # flow level: all arrival states unique with one shared projection
    tgt = best[:, sg.dst_node]
    ab, st = np.nonzero((dist == tgt) & (dist > 0))
    nd = sg.dst_node[st]
    bad = np.zeros((B, n), np.int64)
    np.add.at(bad, (ab, nd), (ucp[ab, st] != 1).astype(np.int64))
    hmin = np.full((B, n), np.iinfo(np.uint64).max, np.uint64)
    hmax = np.zeros((B, n), np.uint64)
    np.minimum.at(hmin, (ab, nd), hproj[ab, st])
    np.maximum.at(hmax, (ab, nd), hproj[ab, st])
    return (bad == 0) & (hmin == hmax)


def _walk_flows(sg: StateGraph, n: int, n_vc: int, SEN: int,
                dist: np.ndarray, best: np.ndarray, src_ids: np.ndarray,
                fb: np.ndarray, fd: np.ndarray, flen: np.ndarray,
                kcap: np.ndarray, K: int,
                uniq: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised backward parent walk for the flows ``(fb, fd)`` of one
    source chunk (``dist``/``best`` rows indexed by ``fb``; ``src_ids``
    maps rows to global source ids).

    ``kcap`` is the per-flow walker budget: slot ``k`` of a flow is
    walked iff ``k < kcap[f]``, and every walked slot is *identical* to
    the corresponding slot of a full-``K`` walk (the budget truncates the
    slot range, it never changes a walker's hash rotation or code), so
    re-walking a flow with a larger budget reproduces its earlier slots
    -- the property the streaming engine's refinement sweep relies on.

    ``uniq`` (optional per-flow bool, from
    :func:`_unique_channel_flows`) marks flows whose shortest state
    paths all share one channel projection: their single walker takes
    the first valid parent at every level directly (an ``argmax`` over
    the parent mask) and skips the hash-rotation / mixed-radix code
    arithmetic entirely. Every candidate such a flow could enumerate
    uses the same channels, so its load contribution -- the only thing
    the greedy and refinement stages compare -- is independent of which
    VC labeling the walker lands on. The uniq lane is deterministic
    (same start state, first-parent rule), so re-walking a uniq flow in
    the refinement sweep reproduces its round-loop candidate exactly.

    K walkers per flow, round-robin over end states; each walker's
    mixed-radix code picks parents so distinct codes -> distinct paths.
    Raw codes always favour parent 0, which correlates every flow's
    candidates onto the same low-id channels and skews the loads the
    min-max selector has to balance -- so both the end-state round-robin
    and each parent digit are rotated by a hash of (flow, decision
    point). Walkers of one flow at the same decision point share the
    rotation, so distinctness is unaffected.

    The walk tolerates *stale* distance fields (the fault-repair path
    re-walks against distances stored before channels died, with the
    dead states masked to -1): a walker whose frontier has no valid
    parent -- or a flow with no live arrival state at its recorded
    length -- is marked dead and its slot dropped from ``k_valid``
    instead of asserting. Every *completed* chain is still a real edge
    path of the claimed length, so stale fields only cost completeness,
    never soundness. With a BFS-consistent ``dist`` (every other
    caller) no walker can die and the output is unchanged.

    Returns SEN-padded ``chan (F_c, K, Lmax)``, ``vc`` and ``k_valid``
    (budget mask minus dead walkers and within-flow duplicates).
    """
    S = sg.n_states
    Lmax = int(flen.max())
    # arrival states achieving the per-destination best distance
    tgt = best[:, sg.dst_node]                           # (B, S)
    bb, st = np.nonzero((dist == tgt) & (dist > 0))
    key = bb * n + sg.dst_node[st]
    grp = np.argsort(key, kind="stable")
    st_sorted, key_sorted = st[grp], key[grp]
    fkey = fb * n + fd
    off = np.searchsorted(key_sorted, fkey)
    cnt = np.searchsorted(key_sorted, fkey, side="right") - off
    fhash = ((src_ids[fb].astype(np.uint64) * np.uint64(0x9E3779B1)
              + fd.astype(np.uint64) * np.uint64(0x85EBCA77))
             >> np.uint64(7))
    Fc = len(fb)
    kcap = np.asarray(kcap, np.int64)
    wstart = np.cumsum(kcap) - kcap
    Wr = int(kcap.sum())
    wflow = np.repeat(np.arange(Fc), kcap)
    wk = np.arange(Wr) - np.repeat(wstart, kcap)         # slot per walker
    alive = np.ones(Wr, bool)
    cnt_safe = np.maximum(cnt, 1)
    if len(st_sorted):
        sidx = off[wflow] + ((wk + fhash[wflow]) % cnt_safe[wflow]) \
            .astype(np.int64)
        start = st_sorted[np.minimum(sidx, len(st_sorted) - 1)]
    else:
        start = np.zeros(Wr, np.int64)
    code = (wk // cnt_safe[wflow]).astype(np.int64)
    cur = start.astype(np.int64)
    wrow = fb[wflow]
    wlen = flen[wflow].copy()
    whash = fhash[wflow]
    dead0 = cnt[wflow] == 0          # no live arrival state at this length
    if dead0.any():
        alive[dead0] = False
        wlen[dead0] = 0
    chan_buf = np.full((Wr, Lmax), SEN, np.int32)
    vc_buf = np.zeros((Wr, Lmax), np.int8)
    chan_buf[np.arange(Wr), wlen - 1] = cur // n_vc
    vc_buf[np.arange(Wr), wlen - 1] = (cur % n_vc).astype(np.int8)
    wuniq = uniq[wflow] if uniq is not None else None
    for lvl in range(Lmax, 1, -1):
        act = np.nonzero(wlen >= lvl)[0]
        par = sg.rev_pad[cur[act]].astype(np.int64)      # (A, D)
        ok = (par >= 0) & (dist[wrow[act][:, None],
                                np.clip(par, 0, S - 1)] == lvl - 1)
        if wuniq is not None and wuniq[act].any():
            ua = wuniq[act]
            au = np.nonzero(ua)[0]
            oku = ok[au]
            ubad = ~oku.any(axis=1)
            if ubad.any():                   # stale dist: walker is stuck
                alive[act[au[ubad]]] = False
                wlen[act[au[ubad]]] = 0
                au, oku = au[~ubad], oku[~ubad]
            # unique flows: the only valid parent, no slot arithmetic
            cur[act[au]] = par[au, oku.argmax(axis=1)]
            ga = np.nonzero(~ua)[0]
        else:
            ga = np.arange(len(act))
        if len(ga):
            ag = act[ga]
            okg = ok[ga]
            npar = okg.sum(axis=1)           # >= 1 with consistent dist
            bad = npar == 0
            if bad.any():                    # stale dist: walker is stuck
                alive[ag[bad]] = False
                wlen[ag[bad]] = 0
                ga, ag = ga[~bad], ag[~bad]
                okg, npar = okg[~bad], npar[~bad]
        if len(ga):
            rot = ((whash[ag] + cur[ag].astype(np.uint64)
                    * np.uint64(0x9E3779B9)
                    + np.uint64(lvl) * np.uint64(0xC2B2AE35))
                   % npar.astype(np.uint64)).astype(np.int64)
            pick = (code[ag] + rot) % npar
            code[ag] //= npar
            sel = okg & (np.cumsum(okg, axis=1) == (pick + 1)[:, None])
            cur[ag] = par[ga, sel.argmax(axis=1)]
        act = act[alive[act]]
        chan_buf[act, lvl - 2] = (cur[act] // n_vc).astype(np.int32)
        vc_buf[act, lvl - 2] = (cur[act] % n_vc).astype(np.int8)
    # dedupe within each flow's slots (64-bit polynomial path hash;
    # padding is identical across a flow's slots so it cancels out)
    h = np.zeros(Wr, np.uint64)
    mul = np.uint64(0x9E3779B97F4A7C15)
    for pos in range(Lmax):
        stcol = (chan_buf[:, pos].astype(np.uint64) * np.uint64(n_vc)
                 + vc_buf[:, pos].astype(np.uint64))
        h = h * mul + stcol + np.uint64(1)
    chan = np.full((Fc, K, Lmax), SEN, np.int32)
    vc = np.zeros((Fc, K, Lmax), np.int8)
    chan[wflow, wk] = chan_buf
    vc[wflow, wk] = vc_buf
    hh = np.zeros((Fc, K), np.uint64)
    hh[wflow, wk] = h
    valid_slot = np.zeros((Fc, K), bool)
    valid_slot[wflow, wk] = alive
    k_valid = valid_slot.copy()
    for k in range(1, K):
        dup = (hh[:, k:k + 1] == hh[:, :k]) & valid_slot[:, :k] \
            & valid_slot[:, k:k + 1]
        k_valid[:, k] &= ~dup.any(axis=1)
    return chan, vc, k_valid


def enumerate_candidates(at: ATResult, K: int = 8,
                         dead_channels: Optional[set] = None,
                         source_chunk: int = 64) -> CandidateSet:
    """Packed ``(F, K, L)`` candidate tensor for all (src, dst) pairs via
    the batched state BFS + a vectorised backward parent walk."""
    ch = at.channels
    sg = at.state_graph()
    n, n_vc = ch.n_nodes, at.n_vc
    SEN = ch.n
    pieces: List[Tuple] = []
    unreachable = 0
    width = 1
    for s0 in range(0, n, source_chunk):
        srcs = np.arange(s0, min(s0 + source_chunk, n))
        dist = state_bfs(at, srcs, dead_channels)
        best = node_distances(at, srcs, dist=dist)           # (B, n)
        unreachable += int((best < 0).sum())
        fb, fd = np.nonzero(best > 0)
        if not len(fb):
            continue
        flen = best[fb, fd].astype(np.int64)                 # (F_c,)
        Lmax = int(flen.max())
        if Lmax > MAXHOP:
            raise ValueError(f"shortest path of {Lmax} hops exceeds "
                             f"MAXHOP={MAXHOP}")
        kcap = np.full(len(fb), K, np.int64)
        chan_c, vc_c, k_valid = _walk_flows(sg, n, n_vc, SEN, dist, best,
                                            srcs, fb, fd, flen, kcap, K)
        pieces.append((srcs[fb], fd, chan_c, vc_c, flen, k_valid))
        width = max(width, Lmax)
    if not pieces:
        z = np.zeros(0, np.int64)
        return CandidateSet(z, z, np.full((0, K, width), SEN, np.int32),
                            np.zeros((0, K, width), np.int8), z,
                            np.zeros((0, K), bool), SEN, unreachable)

    def pad(a, fill, dt):
        if a.shape[2] == width:
            return a
        out = np.full(a.shape[:2] + (width,), fill, dt)
        out[:, :, :a.shape[2]] = a
        return out

    return CandidateSet(
        np.concatenate([p[0] for p in pieces]).astype(np.int64),
        np.concatenate([p[1] for p in pieces]).astype(np.int64),
        np.concatenate([pad(p[2], SEN, np.int32) for p in pieces]),
        np.concatenate([pad(p[3], 0, np.int8) for p in pieces]),
        np.concatenate([p[4] for p in pieces]),
        np.concatenate([p[5] for p in pieces]),
        SEN, unreachable)


# ---------------------------------------------------------------------------
# Min-max channel-load path selection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutingResult:
    table: PathTable                       # packed (s, d) routes (dense
    loads: np.ndarray                      # or CSR); per-channel load
    l_max: float
    avg_hops: float
    unreachable: int
    stats: Optional[dict] = None           # per-stage timings / counters

    @property
    def paths(self) -> Dict[Tuple[int, int], Tuple[int, ...]]:
        """Dict view, materialised on demand (API edge only -- the
        routing -> VC alloc -> simulation pipeline uses ``table``).

        .. deprecated:: use ``table`` (packed arrays) instead.
        """
        warnings.warn(
            "RoutingResult.paths is deprecated for internal use; read "
            "the packed RoutingResult.table instead.",
            DeprecationWarning, stacklevel=2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return self.table.as_dicts()[0]


def select_paths(at: ATResult, K: int = 8, seed: int = 0,
                 dead_channels: Optional[set] = None,
                 local_search_rounds: int = 3,
                 engine: str = "array", block: Optional[int] = None,
                 shard_sources: int = 64, rounds: int = 4,
                 k_min: Optional[int] = None,
                 refine_cap: Optional[int] = None,
                 uniq_dp="auto",
                 dist_out: Optional[np.ndarray] = None,
                 best_out: Optional[np.ndarray] = None,
                 pair_weight: Optional[np.ndarray] = None
                 ) -> RoutingResult:
    """Min-max channel load selection: greedy + local search (the paper
    solves an ILP with Gurobi; we report the achieved L_max against the
    lower bound so the optimality gap is visible).

    ``engine="array"`` (default) runs the batched state-CSR pipeline:
    candidates come from :func:`enumerate_candidates` and cost evaluation
    is blocked over whole flow groups -- the greedy pass gathers channel
    loads for ``block`` flows at once, and local search re-evaluates
    blocks with each flow's own contribution removed exactly. The winning
    candidate's per-hop VCs (from its BFS state path) are written into the
    table alongside the channels. ``engine="reference"`` is the seed's
    per-flow python loop, kept as the equivalence/benchmark oracle.

    ``engine="sharded"`` is the streaming per-source-shard engine for
    large pods (:func:`_select_sharded`): flows are processed shard-at-a-
    time through a fused candidate-walk -> damped greedy pass coordinated
    by a persistent global load vector, with adaptive per-flow walker
    budgets (``k_min`` for cold flows, full ``K`` for flows touching the
    running hot set, a single machinery-free walker for flows with a
    unique shortest path) and a bounded cross-shard refinement sweep
    over the hottest channels (``refine_cap=None`` scales the pool with
    the flow count: ``max(300_000, F // 24)``). It emits a packed
    :class:`~repro.core.pathtable.CSRPathTable` (memory scales with total
    hops, not ``n^2 * MAXHOP``), which the rest of the pipeline consumes
    directly.

    ``uniq_dp`` gates the sharded engine's kcap=1 unique-shortest-path
    DP: ``"auto"`` (default) enables it only on faulted fabrics or pods
    up to 512 nodes, where it pays for itself (at 16^3 it costs ~100 s
    on a CPU host, against smaller walk savings). ``dist_out (n, S) / best_out (n, n)``
    accept preallocated arrays that the sharded engine fills with every
    source's BFS state-distance and node-distance fields -- the
    fault-repair pipeline (:mod:`repro.core.repair`) stores these at
    build time so repairs can re-walk pooled flows without re-running
    the BFS.

    ``pair_weight`` (array engine only) is an ``(n, n)`` matrix of
    non-negative integer demand multiplicities: every load counter
    treats flow ``(s, d)`` as ``pair_weight[s, d]`` unit flows, so the
    min-max objective becomes demand-weighted channel load -- routing
    co-designed with the workload the fabric was synthesized for. An
    all-ones matrix is bit-identical to the unweighted path (the
    weighted arithmetic degenerates to today's exactly).
    """
    if pair_weight is not None and engine != "array":
        raise ValueError("pair_weight requires engine='array' (the "
                         "sharded/reference engines are unweighted)")
    if engine == "reference":
        return _select_paths_reference(at, K=K, seed=seed,
                                       dead_channels=dead_channels,
                                       local_search_rounds=local_search_rounds)
    if engine == "sharded":
        return _select_sharded(at, K=K, seed=seed,
                               dead_channels=dead_channels,
                               local_search_rounds=local_search_rounds,
                               block=block or 512,
                               shard_sources=shard_sources,
                               rounds=rounds, k_min=k_min,
                               refine_cap=refine_cap, uniq_dp=uniq_dp,
                               dist_out=dist_out, best_out=best_out)
    if engine != "array":
        raise ValueError(f"unknown engine {engine!r}")
    t0 = time.time()
    cs = enumerate_candidates(at, K=K, dead_channels=dead_channels)
    t_enum = time.time() - t0
    out = _select_array(at, cs, seed=seed,
                        local_search_rounds=local_search_rounds,
                        block=block or 1024, pair_weight=pair_weight)
    out.stats["enumerate_s"] = round(t_enum, 3)
    return out


def _select_array(at: ATResult, cs: CandidateSet, seed: int = 0,
                  local_search_rounds: int = 3,
                  block: int = 1024,
                  pair_weight: Optional[np.ndarray] = None
                  ) -> RoutingResult:
    ch = at.channels
    n = ch.n_nodes
    SEN = cs.n_ch
    table = PathTable.empty(n, ch.n, at.n_vc)
    F, K, L = cs.chan.shape
    if F == 0:
        return RoutingResult(table, np.zeros(ch.n), 0.0, 0.0,
                             cs.unreachable, stats={})
    cand = cs.chan
    loads = np.zeros(SEN + 1, np.int64)
    if pair_weight is None:
        w = np.ones(F, np.int64)
    else:
        pw = np.asarray(pair_weight)
        if pw.shape != (n, n):
            raise ValueError(f"pair_weight shape {pw.shape} != ({n}, {n})")
        if (pw < 0).any():
            raise ValueError("pair_weight must be non-negative")
        w = np.maximum(np.rint(pw[cs.flow_src, cs.flow_dst]), 1) \
            .astype(np.int64)
    BIG = np.int64(w.sum()) * L + 1
    INF = np.iinfo(np.int64).max
    rng = np.random.default_rng(seed)
    order = rng.permutation(F)
    chosen = np.zeros(F, np.int64)
    ar = np.arange
    stats: dict = {}
    t0 = time.time()

    # greedy pass: whole flow blocks against the running load vector
    for i in range(0, F, block):
        b = order[i:i + block]
        l = loads[cand[b]]                                   # (B, K, L)
        cost = l.max(axis=2) * BIG + l.sum(axis=2)
        cost[~cs.k_valid[b]] = INF
        c = cost.argmin(axis=1)
        chosen[b] = c
        np.add.at(loads, cand[b, c].ravel(), np.repeat(w[b], L))
        loads[SEN] = 0
    stats["greedy_s"] = round(time.time() - t0, 3)
    t0 = time.time()

    # local search: block-parallel re-assignment with exact own-load
    # removal (candidate loads minus the flow's current path multiplicity)
    for _ in range(local_search_rounds):
        changed = 0
        for i in range(0, F, block):
            b = order[i:i + block]
            B = len(b)
            bc = cand[b]                                     # (B, K, L)
            cur = bc[ar(B), chosen[b]]                       # (B, L)
            ladj = loads[bc] - (bc[:, :, :, None]
                                == cur[:, None, None, :]).sum(axis=3) \
                * w[b][:, None, None]
            ladj = np.where(bc == SEN, 0, ladj)
            cost = ladj.max(axis=2) * BIG + ladj.sum(axis=2)
            cost[~cs.k_valid[b]] = INF
            newc = cost.argmin(axis=1)
            better = cost[ar(B), newc] < cost[ar(B), chosen[b]]
            if better.any():
                mv = np.nonzero(better)[0]
                np.add.at(loads, cur[mv].ravel(),
                          np.repeat(-w[b[mv]], cur.shape[1]))
                np.add.at(loads, bc[mv, newc[mv]].ravel(),
                          np.repeat(w[b[mv]], cur.shape[1]))
                loads[SEN] = 0
                chosen[b[mv]] = newc[mv]
                changed += len(mv)
        if changed == 0:
            break
    stats["local_search_s"] = round(time.time() - t0, 3)
    t0 = time.time()

    # hot-set peel: vectorised replacement for the reference's sequential
    # hot-channel walk. Each round takes every flow crossing a channel at
    # the current max load and moves the ones with a *safe* alternative --
    # a candidate whose own-removed loads all sit <= max - 2, so a single
    # move can never mint a new max. Concurrent accepted moves can still
    # collide on an lmax-2 channel, so the best (loads, chosen) snapshot
    # by achieved l_max is kept and restored at the end.
    best_snap = (loads.copy(), chosen.copy(), loads[:SEN].max())
    stall = 0
    for _ in range(0 if local_search_rounds == 0 else 64):
        lm = int(loads[:SEN].max())
        if lm <= 1:
            break
        hot_mask = np.zeros(SEN + 1, bool)
        hot_mask[:SEN][loads[:SEN] == lm] = True
        sel = cand[ar(F), chosen]
        hf = np.nonzero(hot_mask[sel].any(axis=1))[0]
        bc = cand[hf]                                        # (H, K, L)
        cur = sel[hf]
        ladj = loads[bc] - (bc[:, :, :, None]
                            == cur[:, None, None, :]).sum(axis=3) \
            * w[hf][:, None, None]
        ladj = np.where(bc == SEN, 0, ladj)
        # landing at ladj + w must stay < lm: ladj <= lm - 1 - w
        # (the unweighted lm - 2 rule, generalised per flow weight)
        safe = (ladj <= lm - 1 - w[hf][:, None, None]).all(axis=2) \
            & cs.k_valid[hf]
        cost = ladj.max(axis=2) * BIG + ladj.sum(axis=2)
        cost[~safe] = INF
        newc = cost.argmin(axis=1)
        mv = np.nonzero(safe[ar(len(hf)), newc])[0]
        if len(mv) == 0:
            break
        np.add.at(loads, cur[mv].ravel(),
                  np.repeat(-w[hf[mv]], cur.shape[1]))
        np.add.at(loads, bc[mv, newc[mv]].ravel(),
                  np.repeat(w[hf[mv]], cur.shape[1]))
        loads[SEN] = 0
        chosen[hf[mv]] = newc[mv]
        lm_now = loads[:SEN].max()
        if lm_now < best_snap[2]:
            best_snap = (loads.copy(), chosen.copy(), lm_now)
            stall = 0
        else:
            stall += 1
            if stall >= 4:
                break
    if best_snap[2] < loads[:SEN].max():
        loads, chosen = best_snap[0], best_snap[1]
    stats["hot_peel_s"] = round(time.time() - t0, 3)
    t0 = time.time()

    # final sequential hot-channel walk (the reference's exact move rule):
    # the peel above leaves only moves that require cascading through
    # lmax-1 channels, which are few -- a handful of cheap rounds. Rounds
    # stop once l_max stops dropping (plateau churn still counts as
    # "improved" under the reference rule, so a stall counter bounds it).
    stall = 0
    best_walk = int(loads[:SEN].max())
    for _ in range(0 if local_search_rounds == 0 else 24):
        improved = False
        hot = int(np.argmax(loads[:SEN]))
        hot_flows = np.nonzero(
            (cand[ar(F), chosen] == hot).any(axis=1))[0]
        rng.shuffle(hot_flows)
        for f in hot_flows:
            np.add.at(loads, cand[f, chosen[f]], -int(w[f]))
            loads[SEN] = 0
            l = loads[cand[f]]
            cost = l.max(axis=1) * BIG + l.sum(axis=1)
            cost = np.where(cs.k_valid[f], cost, INF)
            best = int(np.argmin(cost))
            if cost[best] >= cost[chosen[f]]:
                best = int(chosen[f])
            if best != chosen[f]:
                improved = True
            chosen[f] = best
            np.add.at(loads, cand[f, best], int(w[f]))
            loads[SEN] = 0
            if loads[:SEN].max() < loads[hot]:
                break
        lm_now = int(loads[:SEN].max())
        if lm_now < best_walk:
            best_walk, stall = lm_now, 0
        else:
            stall += 1
        if not improved or stall >= 6:
            break
    stats["hot_walk_s"] = round(time.time() - t0, 3)

    sel = cand[ar(F), chosen]
    selvc = cs.vc[ar(F), chosen]
    table.set_paths_batch(cs.flow_src, cs.flow_dst,
                          np.where(sel == SEN, -1, sel),
                          cs.length.astype(np.int32), vcs=selvc)
    loads_final = loads[:SEN].astype(np.float64)
    return RoutingResult(table, loads_final,
                         float(loads_final.max()) if F else 0.0,
                         float(cs.length.mean()) if F else 0.0,
                         cs.unreachable, stats=stats)


def _hot_pool(loads: np.ndarray, chan_flat: np.ndarray,
              flow_of_hop: np.ndarray, cap: int, SEN: int
              ) -> Tuple[np.ndarray, int]:
    """Flows crossing the hottest channels, bounded by ``cap``.

    The threshold is the lowest load such that the summed loads of all
    channels at or above it stay within ``cap`` -- the sum bounds the
    pool size from above (a flow crossing j hot channels is counted j
    times), so the re-walked candidate pool is memory-bounded no matter
    how flat the load distribution is.
    """
    l = loads[:SEN]
    live = np.nonzero(l > 1)[0]
    if not len(live):
        return np.zeros(0, np.int64), 0
    order = live[np.argsort(-l[live], kind="stable")]
    k = int(np.searchsorted(np.cumsum(l[order]), cap, side="right"))
    hotc = order[:max(k, 1)]        # top-k channels, not a threshold --
    thresh = int(l[hotc].min())     # load ties can't overshoot the cap
    hot = np.zeros(SEN + 1, bool)
    hot[hotc] = True
    return np.unique(flow_of_hop[hot[chan_flat]]).astype(np.int64), thresh


def _refine_candidates(loads: np.ndarray, candP: np.ndarray,
                       kvP: np.ndarray, pchosen: np.ndarray, rng,
                       SEN: int, BIG: np.int64,
                       local_search_rounds: int, refine_block: int,
                       lm_before: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact own-load-removal local search + safe hot-set peel + bounded
    sequential hot-channel walk over a re-walked candidate pool
    ``candP (P, K, L)`` with slot choices ``pchosen``, snapshot-guarded
    so the achieved ``l_max`` never regresses past ``lm_before``.

    This is the sharded engine's cross-shard refinement primitive,
    shared verbatim with the fault-repair re-route
    (:func:`repro.core.repair.repair_fault`): the repair pool's flows
    are refined against the live load vector exactly like a hot-pool
    sweep. ``loads`` includes every flow outside the pool as fixed
    background. Returns the (possibly snapshot-restored) ``loads`` and
    ``pchosen``; the caller writes moved flows back into its table.
    """
    ar = np.arange
    P = len(pchosen)
    snap = (loads.copy(), pchosen.copy(), lm_before)
    # exact own-load-removal local search over the pool (small
    # blocks: concurrent same-block moves collide on the same
    # cold channels, and the churn costs ~5% l_max at 1024)
    for _ in range(local_search_rounds):
        changed = 0
        for i in range(0, P, refine_block):
            b = slice(i, min(i + refine_block, P))
            B2 = b.stop - b.start
            bc = candP[b]
            cur = bc[ar(B2), pchosen[b]]
            ladj = loads[bc] - (bc[:, :, :, None]
                                == cur[:, None, None, :]).sum(axis=3)
            ladj = np.where(bc == SEN, 0, ladj)
            cost = ladj.max(axis=2) * BIG + ladj.sum(axis=2)
            cost[~kvP[b]] = np.iinfo(np.int64).max
            newc = cost.argmin(axis=1)
            better = cost[ar(B2), newc] < cost[ar(B2), pchosen[b]]
            mv = np.nonzero(better)[0]
            if len(mv):
                np.add.at(loads, cur[mv].ravel(), -1)
                np.add.at(loads, bc[mv, newc[mv]].ravel(), 1)
                loads[SEN] = 0
                pchosen[i + mv] = newc[mv]
                changed += len(mv)
        lm_now = int(loads[:SEN].max())
        if lm_now < snap[2]:
            snap = (loads.copy(), pchosen.copy(), lm_now)
        if changed == 0:
            break
    # safe hot-set peel (single moves can never mint a new max)
    stall = 0
    for _ in range(64):
        lm = int(loads[:SEN].max())
        if lm <= 1:
            break
        hot_mask = np.zeros(SEN + 1, bool)
        hot_mask[:SEN][loads[:SEN] == lm] = True
        sel = candP[ar(P), pchosen]
        hf = np.nonzero(hot_mask[sel].any(axis=1))[0]
        if not len(hf):
            break
        bc = candP[hf]
        cur = sel[hf]
        ladj = loads[bc] - (bc[:, :, :, None]
                            == cur[:, None, None, :]).sum(axis=3)
        ladj = np.where(bc == SEN, 0, ladj)
        safe = (ladj <= lm - 2).all(axis=2) & kvP[hf]
        cost = ladj.max(axis=2) * BIG + ladj.sum(axis=2)
        cost[~safe] = np.iinfo(np.int64).max
        newc = cost.argmin(axis=1)
        mv = np.nonzero(safe[ar(len(hf)), newc])[0]
        if len(mv) == 0:
            break
        np.add.at(loads, cur[mv].ravel(), -1)
        np.add.at(loads, bc[mv, newc[mv]].ravel(), 1)
        loads[SEN] = 0
        pchosen[hf[mv]] = newc[mv]
        lm_now = loads[:SEN].max()
        if lm_now < snap[2]:
            snap = (loads.copy(), pchosen.copy(), int(lm_now))
            stall = 0
        else:
            stall += 1
            if stall >= 4:
                break
    if snap[2] < loads[:SEN].max():
        loads, pchosen = snap[0].copy(), snap[1].copy()
    # short sequential hot-channel walk (exact reference rule)
    stall = 0
    best_walk = int(loads[:SEN].max())
    for _ in range(8):
        improved = False
        hot = int(np.argmax(loads[:SEN]))
        hot_flows = np.nonzero(
            (candP[ar(P), pchosen] == hot).any(axis=1))[0]
        rng.shuffle(hot_flows)
        for f in hot_flows[:4096]:
            np.add.at(loads, candP[f, pchosen[f]], -1)
            loads[SEN] = 0
            l = loads[candP[f]]
            cost = l.max(axis=1) * BIG + l.sum(axis=1)
            cost = np.where(kvP[f], cost, np.iinfo(np.int64).max)
            bestk = int(np.argmin(cost))
            if cost[bestk] >= cost[pchosen[f]]:
                bestk = int(pchosen[f])
            if bestk != pchosen[f]:
                improved = True
            pchosen[f] = bestk
            np.add.at(loads, candP[f, bestk], 1)
            loads[SEN] = 0
            if loads[:SEN].max() < loads[hot]:
                break
        lm_now = int(loads[:SEN].max())
        if lm_now < best_walk:
            best_walk, stall = lm_now, 0
        else:
            stall += 1
        if not improved or stall >= 3:
            break
    return loads, pchosen


def _select_sharded(at: ATResult, K: int = 8, seed: int = 0,
                    dead_channels: Optional[set] = None,
                    local_search_rounds: int = 3, block: int = 512,
                    shard_sources: int = 64, rounds: int = 4,
                    k_min: Optional[int] = None,
                    refine_cap: Optional[int] = None, damp: float = 1.0,
                    hot_load_frac: float = 0.97,
                    refine_iters: int = 2,
                    refine_block: int = 192,
                    uniq_dp="auto",
                    dist_out: Optional[np.ndarray] = None,
                    best_out: Optional[np.ndarray] = None
                    ) -> RoutingResult:
    """Streaming per-source-shard path selection (the large-pod engine).

    The whole-array engine materialises every flow's candidates at once
    (``F = n (n-1)`` rows), which dominates wall-clock and memory past
    ~10^3 nodes. Here the flow problem is decomposed into coordinated
    per-source shards:

    - **Phase 0** runs the batched state BFS shard-at-a-time and keeps
      only the ``(B, S)`` distance fields plus the per-flow lengths --
      enough to rebuild any flow's candidates on demand -- and lays out
      the packed :class:`CSRPathTable` skeleton (per-source offsets +
      concatenated hop arrays) that selection writes into in place.
    - **Streaming rounds**: each round walks and greedily assigns a
      random 1/``rounds`` slice of every shard's flows against the
      *persistent global load vector*, so later decisions see an
      unbiased sample of the final landscape (a single source-ordered
      pass is ~20% worse: early shards dump load geographically).
      Residual-load damping adds the expected remaining demand -- a
      prior bootstrapped from the candidate densities walked so far,
      scaled to the unprocessed flow fraction -- which stops early
      slices from herding onto currently-cold channels.
    - **Adaptive walker budgets**: flows touching the running hot set
      (endpoints of near-``l_max`` channels) walk the full ``K``
      candidates; short or uncontested flows walk ``k_min``, and flows
      whose BFS field admits a *single shortest channel path*
      (:func:`_unique_channel_flows`) walk exactly one candidate with
      the slot machinery skipped. Budgeted slots are bit-identical to
      the full walk's slots, so the refinement sweep can re-walk any
      flow at full ``K`` and recover its current choice exactly.
    - **Cross-shard refinement**: a bounded sweep over the hottest
      channels -- flows crossing them (capped by ``refine_cap``;
      ``None`` auto-scales to ``max(300_000, F // 24)`` so the pool
      stays ~4% of the flows at 16^3 instead of a fixed 1.2%) are
      re-walked at full ``K`` and re-optimised with the array engine's
      exact own-load-removal local search, safe hot-set peel and
      sequential hot-channel walk, all snapshot-guarded so ``l_max``
      never regresses.

    Emits a :class:`CSRPathTable` whose VC hops are the winning
    candidates' BFS state paths (valid by construction); the balanced
    re-allocation stays in :func:`repro.core.vcalloc.allocate_vcs`.
    """
    ch = at.channels
    sg = at.state_graph()
    n, n_vc = ch.n_nodes, at.n_vc
    SEN = ch.n
    if k_min is None:
        k_min = max(2, K // 2)
    k_min = max(1, min(k_min, K))
    stats: dict = {"engine": "sharded", "rounds": rounds,
                   "shard_sources": shard_sources, "k_min": k_min}
    ar = np.arange
    if uniq_dp == "auto":
        # the kcap=1 uniq-flow DP pays off on faulted/irregular fabrics
        # (broken symmetry leaves many single-shortest-path flows) and
        # on small pods where its cost is trivial; on large healthy
        # tori it costs far more than the walk time it saves (101.6 s
        # at 16^3, measured on a CPU host)
        has_dead = dead_channels is not None and len(dead_channels) > 0
        uniq_dp = bool(has_dead or n <= 512)
    stats["uniq_dp"] = bool(uniq_dp)

    # ---- phase 0: per-shard BFS + CSR skeleton ---------------------------
    t0 = time.time()
    n_shards = (n + shard_sources - 1) // shard_sources
    shard_dist: List[np.ndarray] = []
    shard_best: List[np.ndarray] = []
    shard_fb: List[np.ndarray] = []
    shard_fd: List[np.ndarray] = []
    shard_flen: List[np.ndarray] = []
    shard_uniq: List[np.ndarray] = []
    gid0 = np.zeros(n_shards + 1, np.int64)
    src_flow_counts = np.zeros(n, np.int64)
    unreachable = 0
    uniq_flows = 0
    t_nsp = 0.0
    for si in range(n_shards):
        s0 = si * shard_sources
        srcs = np.arange(s0, min(s0 + shard_sources, n))
        dist = state_bfs(at, srcs, dead_channels)
        best = node_distances(at, srcs, dist=dist)
        if dist_out is not None:
            dist_out[srcs] = dist.astype(dist_out.dtype)
        if best_out is not None:
            best_out[srcs] = best.astype(best_out.dtype)
        unreachable += int((best < 0).sum())
        fb, fd = np.nonzero(best > 0)
        flen = best[fb, fd].astype(np.int64)
        if len(flen) and int(flen.max()) > MAXHOP:
            raise ValueError(f"shortest path of {int(flen.max())} hops "
                             f"exceeds MAXHOP={MAXHOP}")
        if uniq_dp:
            t1 = time.time()
            uniq = _unique_channel_flows(sg, dist, best, n)[fb, fd]
            t_nsp += time.time() - t1
            uniq_flows += int(uniq.sum())
        else:
            uniq = np.zeros(len(fb), bool)
        shard_dist.append(dist)
        shard_best.append(best.astype(np.int16))
        shard_fb.append(fb.astype(np.int64))
        shard_fd.append(fd.astype(np.int64))
        shard_flen.append(flen)
        shard_uniq.append(uniq)
        gid0[si + 1] = gid0[si] + len(fb)
        src_flow_counts[srcs] = np.bincount(fb, minlength=len(srcs))
    F = int(gid0[-1])
    if refine_cap is None:
        refine_cap = max(300_000, F // 24)
    stats["refine_cap"] = int(refine_cap)
    stats["uniq_flows"] = uniq_flows
    stats["uniq_s"] = round(t_nsp, 3)
    flen_all = (np.concatenate(shard_flen) if F else
                np.zeros(0, np.int64)).astype(np.int64)
    dst_all = (np.concatenate(shard_fd) if F else
               np.zeros(0, np.int64)).astype(np.int32)
    src_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(src_flow_counts, out=src_indptr[1:])
    hop_indptr = np.zeros(F + 1, np.int64)
    np.cumsum(flen_all, out=hop_indptr[1:])
    chan_flat = np.zeros(int(hop_indptr[-1]), np.int32)
    vc_flat = np.zeros(int(hop_indptr[-1]), np.int8)
    chosen_k = np.zeros(F, np.int8)
    stats["bfs_s"] = round(time.time() - t0, 3)
    csr = CSRPathTable(n, SEN, n_vc, src_indptr, dst_all, hop_indptr,
                       chan_flat, vc_flat)
    if F == 0:
        return RoutingResult(csr, np.zeros(SEN), 0.0, 0.0, unreachable,
                             stats=stats)

    # ---- streaming rounds: fused walk -> damped greedy -------------------
    loads = np.zeros(SEN + 1, np.int64)
    ehat = np.zeros(SEN + 1, np.float64)   # bootstrapped expected load
    ehat_flows = 0
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(len(fb)) for fb in shard_fb]
    BIGF = float(np.int64(F) * max(int(flen_all.max()), 1) + 1)
    t_walk = t_greedy = 0.0
    done = 0
    k_full_flows = 0
    for r in range(rounds):
        for si in range(n_shards):
            fb, fd, flen = shard_fb[si], shard_fd[si], shard_flen[si]
            Fc = len(fb)
            idx = perms[si][Fc * r // rounds:Fc * (r + 1) // rounds]
            if not len(idx):
                continue
            t1 = time.time()
            s0 = si * shard_sources
            srcs = np.arange(s0, min(s0 + shard_sources, n))
            fl = flen[idx]
            # adaptive budget: full K for flows touching the hot set
            lm_run = int(loads[:SEN].max())
            if lm_run > 1:
                hotc = np.nonzero(
                    loads[:SEN] >= max(2, int(hot_load_frac * lm_run)))[0]
                hot_nodes = np.zeros(n, bool)
                hot_nodes[ch.src[hotc]] = True
                hot_nodes[ch.dst[hotc]] = True
                hot_f = hot_nodes[s0 + fb[idx]] | hot_nodes[fd[idx]]
            else:
                hot_f = np.zeros(len(idx), bool)
            uq = shard_uniq[si][idx]
            kcap = np.where(hot_f, K, k_min)
            kcap = np.minimum(kcap, np.where(fl == 1, 1,
                                             np.where(fl == 2, 2, K)))
            kcap = np.where(uq, 1, kcap)
            k_full_flows += int((kcap >= K).sum())
            chan_c, vc_c, kv = _walk_flows(sg, n, n_vc, SEN,
                                           shard_dist[si], shard_best[si],
                                           srcs, fb[idx], fd[idx], fl,
                                           kcap, K, uniq=uq)
            t_walk += time.time() - t1
            t1 = time.time()
            B, _, Lc = chan_c.shape
            # fold this slice into the expected-load prior (uniform over
            # each flow's valid slots), then damp the greedy with the
            # scaled unprocessed remainder. Round 1 alone is an unbiased
            # sample of every shard, so later rounds skip the scatter
            # (it costs ~F*K*L adds) and reuse the round-1 estimate.
            if r == 0 and damp > 0.0:
                w = kv / kv.sum(axis=1)[:, None]
                np.add.at(ehat, chan_c.ravel(),
                          np.repeat(w.ravel(), Lc))
                ehat[SEN] = 0.0
                ehat_flows += B
            scale = damp * (1.0 - done / F) * (F / max(ehat_flows, 1)) \
                if ehat_flows else 0.0
            chosen_local = np.zeros(B, np.int64)
            for j in range(0, B, block):
                bc = chan_c[j:j + block]
                l = loads[bc].astype(np.float64)
                if scale > 0.0:
                    l += scale * ehat[bc]
                cost = l.max(axis=2) * BIGF + l.sum(axis=2)
                cost[~kv[j:j + block]] = np.inf
                c = np.argmin(cost, axis=1)
                chosen_local[j:j + block] = c
                np.add.at(loads, bc[ar(len(c)), c].ravel(), 1)
                loads[SEN] = 0
            done += B
            # write winners straight into the CSR skeleton
            gid = gid0[si] + idx
            sel = chan_c[ar(B), chosen_local]
            selvc = vc_c[ar(B), chosen_local]
            pos = ar(Lc)[None, :]
            live = pos < fl[:, None]
            flat = (hop_indptr[gid][:, None] + pos)[live]
            chan_flat[flat] = sel[live]
            vc_flat[flat] = selvc[live]
            chosen_k[gid] = chosen_local
            t_greedy += time.time() - t1
    stats["walk_s"] = round(t_walk, 3)
    stats["greedy_s"] = round(t_greedy, 3)
    stats["k_full_flows"] = k_full_flows
    stats["greedy_l_max"] = int(loads[:SEN].max())

    # ---- cross-shard refinement over the hottest channels ----------------
    t0 = time.time()
    stats.update({"refine_pool": 0, "refine_moved": 0, "refine_iters": 0,
                  "refine_thresh": 0})
    if local_search_rounds > 0:
        flow_of_hop = np.repeat(ar(F, dtype=np.int64), flen_all)
        for _ in range(refine_iters):
            lm_before = int(loads[:SEN].max())
            pool, thresh = _hot_pool(loads, chan_flat, flow_of_hop,
                                     refine_cap, SEN)
            if not len(pool):
                break
            stats["refine_iters"] += 1
            stats["refine_pool"] = max(stats["refine_pool"], len(pool))
            stats["refine_thresh"] = thresh
            # re-walk the pool at full K (cached distances; budgeted
            # slots reproduce, so chosen_k still indexes correctly)
            seg = np.searchsorted(pool, gid0)
            parts = []
            Lp = 1
            for si in range(n_shards):
                a, b = seg[si], seg[si + 1]
                if a == b:
                    continue
                loc = pool[a:b] - gid0[si]
                s0 = si * shard_sources
                srcs = np.arange(s0, min(s0 + shard_sources, n))
                fl = shard_flen[si][loc]
                uq = shard_uniq[si][loc]
                cc, vv, kvp = _walk_flows(
                    sg, n, n_vc, SEN, shard_dist[si], shard_best[si],
                    srcs, shard_fb[si][loc], shard_fd[si][loc], fl,
                    np.where(uq, 1, K).astype(np.int64), K, uniq=uq)
                parts.append((cc, vv, kvp))
                Lp = max(Lp, cc.shape[2])

            def padc(a, fill):
                if a.shape[2] == Lp:
                    return a
                out = np.full(a.shape[:2] + (Lp,), fill, a.dtype)
                out[:, :, :a.shape[2]] = a
                return out

            candP = np.concatenate([padc(p[0], SEN) for p in parts])
            vcP = np.concatenate([padc(p[1], 0) for p in parts])
            kvP = np.concatenate([p[2] for p in parts])
            P = len(pool)
            pchosen = chosen_k[pool].astype(np.int64)
            old_pchosen = pchosen.copy()
            loads, pchosen = _refine_candidates(
                loads, candP, kvP, pchosen, rng, SEN, np.int64(BIGF),
                local_search_rounds, refine_block, lm_before)
            # write the moved flows back into the CSR arrays
            moved = np.nonzero(pchosen != old_pchosen)[0]
            stats["refine_moved"] += len(moved)
            if len(moved):
                mg = pool[moved]
                lens = flen_all[mg]
                sel = candP[moved, pchosen[moved]]
                selvc = vcP[moved, pchosen[moved]]
                pos = ar(Lp)[None, :]
                live = pos < lens[:, None]
                flat = (hop_indptr[mg][:, None] + pos)[live]
                chan_flat[flat] = sel[live]
                vc_flat[flat] = selvc[live]
                chosen_k[mg] = pchosen[moved]
            if int(loads[:SEN].max()) >= lm_before:
                break
    stats["refine_s"] = round(time.time() - t0, 3)

    loads_final = loads[:SEN].astype(np.float64)
    return RoutingResult(csr, loads_final, float(loads_final.max()),
                         float(flen_all.mean()), unreachable, stats=stats)


def _select_paths_reference(at: ATResult, K: int = 8, seed: int = 0,
                            dead_channels: Optional[set] = None,
                            local_search_rounds: int = 3) -> RoutingResult:
    """The seed's per-flow python greedy + hot-channel local search, driven
    by the per-source python BFS enumerator. Equivalence/benchmark oracle
    for the array engine."""
    ch = at.channels
    n = ch.n_nodes
    SEN = ch.n                      # sentinel channel id; its load stays 0
    f_cap = n * (n - 1)
    cand = np.full((f_cap, K, MAXHOP), SEN, np.int32)
    cand_len = np.zeros((f_cap, K), np.int32)
    cand_k = np.zeros(f_cap, np.int32)
    flow_src = np.zeros(f_cap, np.int32)
    flow_dst = np.zeros(f_cap, np.int32)
    F = 0
    unreachable = 0
    for s in range(n):
        per_dest = candidate_paths(at, s, K=K, dead_channels=dead_channels)
        for d in range(n):
            if d == s:
                continue
            plist = per_dest.get(d)
            if not plist:
                unreachable += 1
                continue
            flow_src[F] = s
            flow_dst[F] = d
            for i, p in enumerate(plist[:K]):
                L = min(len(p), MAXHOP)
                cand[F, i, :L] = p[:L]
                cand_len[F, i] = L
            cand_k[F] = len(plist[:K])
            F += 1
    cand = cand[:F]
    cand_len = cand_len[:F]
    cand_k = cand_k[:F]
    flow_src = flow_src[:F]
    flow_dst = flow_dst[:F]

    loads = np.zeros(SEN + 1, np.int64)
    chosen = np.zeros(F, np.int32)
    rng = np.random.default_rng(seed)
    valid = np.arange(K)[None, :] < cand_k[:, None]      # (F, K)
    BIG = np.int64(F) * MAXHOP + 1
    INF = np.iinfo(np.int64).max

    def flow_costs(f: int) -> np.ndarray:
        """Lexicographic (l_max, l_sum) per candidate, packed in one int."""
        l = loads[cand[f]]                               # (K, MAXHOP)
        cost = l.max(axis=1) * BIG + l.sum(axis=1)
        return np.where(valid[f], cost, INF)

    def add_path(f: int, i: int, sign: int) -> None:
        np.add.at(loads, cand[f, i], sign)
        loads[SEN] = 0

    order = np.arange(F)
    rng.shuffle(order)
    for f in order:
        best = int(np.argmin(flow_costs(f)))
        chosen[f] = best
        add_path(f, best, +1)

    for _ in range(local_search_rounds):
        improved = False
        hot = int(np.argmax(loads[:SEN]))
        sel = cand[np.arange(F), chosen]                 # (F, MAXHOP)
        hot_flows = np.nonzero((sel == hot).any(axis=1))[0]
        rng.shuffle(hot_flows)
        for f in hot_flows:
            add_path(f, chosen[f], -1)
            costs = flow_costs(f)
            best = int(np.argmin(costs))
            if costs[best] >= costs[chosen[f]]:
                best = int(chosen[f])
            if best != chosen[f]:
                improved = True
            chosen[f] = best
            add_path(f, best, +1)
            if loads[:SEN].max() < loads[hot]:
                break
        if not improved:
            break

    table = PathTable.empty(n, ch.n, at.n_vc)
    sel = cand[np.arange(F), chosen]                     # (F, MAXHOP)
    lengths = cand_len[np.arange(F), chosen]
    table.set_paths_batch(flow_src, flow_dst,
                          np.where(sel == SEN, -1, sel), lengths)
    loads_final = loads[:SEN].astype(np.float64)
    avg_hops = float(lengths.mean()) if F else 0.0
    return RoutingResult(table, loads_final, float(loads_final.max())
                         if F else 0.0, avg_hops, unreachable)


def load_lower_bound(topo: Topology, device=None) -> float:
    """L_max >= total shortest-path channel-visits / #channels."""
    from repro_torch.core.topology import bfs_all_pairs
    d = bfs_all_pairs(topo, device=device)
    total = d[np.isfinite(d)].sum()
    return total / (2 * len(topo.edges()))


def turn_frequencies(table: PathTable) -> Dict[Tuple[int, int], float]:
    """Turn usage of a chosen routing (for the CPL prioritisation).

    Vectorised bigram count over the packed path array; the returned dict
    is keyed by turn (not by flow) and only feeds synthesis-time turn
    prioritisation -- an API edge, not the simulation hot path.
    """
    a = table.path[..., :-1].astype(np.int64)
    b = table.path[..., 1:].astype(np.int64)
    ok = (a >= 0) & (b >= 0)
    keys = a[ok] * table.n_ch + b[ok]
    uniq, counts = np.unique(keys, return_counts=True)
    return {(int(k // table.n_ch), int(k % table.n_ch)): float(c)
            for k, c in zip(uniq, counts)}
