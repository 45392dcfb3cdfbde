"""VC allocation along chosen paths (paper Section 5.4).

Port copy of ``repro.core.vcalloc``: numpy on the host, unchanged.

Each selected channel-path gets a per-hop VC assignment found over the
allowed-turn CDG. The naive policy biases VC 0; TONS's online load
balancer marks the VC with the lowest accumulated hop count as "priority"
before each path and tries it first at every hop.

Assignment is an exact-lookahead DP, vectorised over flow blocks: every
consecutive channel pair resolves to a *turn id* with one batched
``searchsorted`` against the sorted base-turn keys, giving a direct-index
``(T, n_vc, n_vc)`` VC-compatibility table; a backward sweep marks which
VCs at each hop still admit a complete suffix, and the forward sweep then
takes the first priority-ordered VC that is both edge-compatible and
suffix-viable. That is bit-for-bit the assignment the reference per-flow
DFS (:func:`_assign_path`) finds -- depth-first in priority order, first
complete solution -- but with no per-flow python fallback at all. The old
vectorised first-fit dead-ended on ~45% of flows at 8^3 and fell back to
that DFS per flow, which dominated allocation wall-clock; the counter
``greedy_dead_ends`` in the optional ``stats`` dict records how many
flows would have taken that path, seeding the simulated greedy's hop 0
with the unconditional priority VC exactly as the old code did (the
lookahead resolves them all in the same vectorised pass).

Both path-table layouts are accepted: the dense ``(n, n, MAXHOP)``
:class:`~repro.core.pathtable.PathTable` and the packed
:class:`~repro.core.pathtable.CSRPathTable` emitted by the streaming
sharded selection engine (blocks stream through
:meth:`~repro.core.pathtable.CSRPathTable.block_paths` /
:meth:`~repro.core.pathtable.CSRPathTable.set_block_vcs`). Assignments
are written in place; per-VC hop counts come back as a vector.
Dict-based inputs are not accepted -- convert at the edge with
:meth:`PathTable.from_dicts`.

The :class:`~repro.core.routing.ATResult` consumed here is engine-
agnostic: the batched admission engine and the serial reference produce
the identical allowed set, and the ``StateGraph`` they compile to is
canonical, so allocations are bit-identical either way.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.pathtable import CSRPathTable, PathTable
from repro_torch.core.routing import (ATResult, Channels,
                                      _dead_channel_array,
                                      _tree_turns_array)


# ---------------------------------------------------------------------------
# Escape sub-network: VC 0 over a spanning-tree turn set
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EscapeRoutes:
    """The always-safe escape sub-network for adaptive routing.

    A BFS spanning tree over the *surviving* channels, its non-reversing
    turn set (acyclic -- tree turns cannot close a cycle, the same
    argument that seeds the allowed-turn admission), and the per-node
    next-hop table the simulator kernel consumes: ``esc_next[u, d]`` is
    the channel leaving ``u`` toward ``d`` along the unique tree path
    (``-1`` on the diagonal and for unreachable pairs). A packet riding
    VC 0 follows ``esc_next`` hop by hop and never leaves the tree, so
    the escape channel-dependency graph is acyclic regardless of what
    the adaptive VCs are doing -- Duato's condition for deadlock-free
    adaptive routing with a connected escape layer.
    """
    n: int
    tree_channels: np.ndarray   # (2(n-1),) both directions of tree edges
    esc_next: np.ndarray        # (n, n) int32 next channel toward d, -1 pad
    turns: np.ndarray           # (K, 2) (cin, cout) tree-turn set
    connected: bool             # tree spans every surviving node pair


def escape_routes(topo, dead_channels=None, root: int = 0) -> EscapeRoutes:
    """Build the escape tree + next-hop table over surviving channels.

    Dead channels are excluded before the BFS, so after a fault the
    caller rebuilds this on the survivors and gets a valid post-fault
    escape layer (the netsim kernel stacks the pre/post tables and
    switches at the fault cycle).
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
    a = sp.csr_matrix((np.ones(int(alive.sum()), np.float32),
                       (ch.src[alive], ch.dst[alive])), shape=(n, n))
    # BFS tree from `root`, then all-pairs next hops along the tree:
    # pred[d, u] is u's predecessor on the path d -> u, i.e. the next
    # node from u toward d (tree paths are unique and undirected)
    tree = csg.breadth_first_tree(a, root, directed=False)
    tr, tc = tree.nonzero()
    und = sp.csr_matrix((np.ones(len(tr), np.float32), (tr, tc)),
                        shape=(n, n))
    und = und + und.T
    dist, pred = csg.shortest_path(und, unweighted=True,
                                   return_predecessors=True)
    nxt = pred.T                                 # (u, d) -> next node
    chan_of = np.full((n, n), -1, np.int32)
    chan_of[ch.src[alive], ch.dst[alive]] = \
        np.arange(ch.n, dtype=np.int32)[alive]
    uu = np.repeat(np.arange(n), n)
    vv = np.clip(nxt.ravel(), 0, n - 1)
    esc_next = np.where(nxt.ravel() >= 0, chan_of[uu, vv], -1) \
        .astype(np.int32).reshape(n, n)
    np.fill_diagonal(esc_next, -1)
    # both directions of every tree edge, as channel ids
    fwd = chan_of[tr, tc]
    bwd = chan_of[tc, tr]
    tree_ch = np.concatenate([fwd, bwd])
    tree_ch = np.sort(tree_ch[tree_ch >= 0]).astype(np.int64)
    turns = _tree_turns_array(tree_ch.tolist(), ch)
    connected = bool((dist[root] != np.inf).all()) and len(tr) == n - 1
    return EscapeRoutes(n, tree_ch, esc_next, turns, connected)


def _assign_path(at: ATResult, path, priority: int) -> Optional[List[int]]:
    """DFS over VC choices along a fixed channel sequence; tries the
    priority VC first at every hop. Reference oracle for the vectorised
    lookahead assignment (both return the depth-first-first solution)."""
    n_vc = at.n_vc
    order = [priority] + [v for v in range(n_vc) if v != priority]

    def rec(i: int, v_prev: int) -> Optional[List[int]]:
        if i == len(path):
            return []
        for v in order:
            if i == 0 or at.is_allowed(path[i - 1], v_prev, path[i], v):
                rest = rec(i + 1, v)
                if rest is not None:
                    return [v] + rest
        return None

    return rec(0, -1)


def _turn_vc_table(at: ATResult) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted base-turn keys ``c_in * C + c_out`` plus the per-turn VC
    compatibility table ``vcmat (T + 2, n_vc, n_vc)``.

    Row ``T`` is the all-True pad (positions beyond a flow's length),
    row ``T + 1`` the all-False row for channel pairs that admit no VC
    combination at all. Built once per ATResult and cached.
    """
    cached = getattr(at, "_vcmat_cache", None)
    if cached is not None:
        return cached
    sg = at.state_graph()
    S, n_vc = sg.n_states, sg.n_vc
    a, b = sg.keys // S, sg.keys % S
    C = S // n_vc
    tk = (a // n_vc) * C + (b // n_vc)
    turn_keys = np.unique(tk)
    T = len(turn_keys)
    vcmat = np.zeros((T + 2, n_vc, n_vc), bool)
    vcmat[np.searchsorted(turn_keys, tk), a % n_vc, b % n_vc] = True
    vcmat[T] = True
    at._vcmat_cache = (turn_keys, vcmat)
    return turn_keys, vcmat


def _lookahead_vcs(at: ATResult, P: np.ndarray, lens: np.ndarray,
                   vorder: List[int], stats: Optional[dict] = None,
                   forbid_vc0: bool = False) -> np.ndarray:
    """Exact-lookahead per-hop VC assignment for a block of paths.

    ``P (B, W)`` are channel sequences (< 0 pad), ``lens`` the true hop
    counts. Returns ``V (B, W)`` (garbage beyond each flow's length);
    raises if some flow admits no valid assignment at all.

    ``forbid_vc0`` reserves VC 0 as the adaptive-routing escape lane:
    assignments are restricted to VCs >= 1, and a flow with no viable
    all-adaptive assignment falls back to an all-VC0 marking instead of
    raising (counted in ``stats['escape_fallback_flows']``) -- the
    adaptive kernel treats a VC0 occupant as escape-routed from hop 0,
    which is always deliverable over the escape tree.
    """
    turn_keys, vcmat = _turn_vc_table(at)
    n_vc = at.n_vc
    B, W = P.shape
    C = at.channels.n
    T = len(turn_keys)
    rows = np.arange(B)
    tid = np.full((B, max(W - 1, 1)), T, np.int64)
    if W > 1:
        pairpos = np.arange(W - 1)[None, :] < (lens - 1)[:, None]
        q = P[:, :-1].astype(np.int64) * C + P[:, 1:]
        ti = np.clip(np.searchsorted(turn_keys, np.clip(q, 0, None)),
                     0, max(T - 1, 0))
        found = (turn_keys[ti] == q) if T else np.zeros_like(pairpos)
        tid[pairpos & found] = ti[pairpos & found]
        tid[pairpos & ~found] = T + 1          # no VC combo admits this
    # one bulk compatibility gather for the whole block, then a backward
    # sweep: can the suffix from hop h on VC v still complete?
    M = vcmat[tid].astype(np.uint8)            # (B, W-1, n_vc, n_vc)
    backs = np.ones((B, W, n_vc), np.uint8)
    if forbid_vc0:
        backs[:, :, 0] = 0                     # VC0 is the escape lane
    for h in range(W - 2, -1, -1):
        np.einsum("bij,bj->bi", M[:, h], backs[:, h + 1],
                  out=backs[:, h])
        np.minimum(backs[:, h], 1, out=backs[:, h])
        if forbid_vc0:
            # keep VC0 out of the viability recursion too: a suffix that
            # completes only through VC0 must not count as viable
            backs[:, h, 0] = 0
    # forward sweep: first priority-ordered VC that is edge-compatible
    # with the previous hop and suffix-viable; track alongside what the
    # lookahead-free greedy would have done (its dead-ends are the flows
    # the old implementation sent to the per-flow DFS fallback)
    V = np.zeros((B, W), np.int64)
    choice = np.full(B, -1, np.int64)
    for v in vorder:
        pick = (choice < 0) & (backs[:, 0, v] > 0)
        choice[pick] = v
    ok = choice >= 0
    V[:, 0] = np.where(ok, choice, 0)
    # the old first-fit put the priority VC on hop 0 unconditionally;
    # seed the simulated greedy the same way so the dead-end counter
    # reports what that implementation would actually have hit
    naive = np.full(B, vorder[0], np.int64)
    ndead = ~ok
    for h in range(1, W):
        live = lens > h
        m = M[:, h - 1]
        allowed_next = m[rows, V[:, h - 1]]    # (B, n_vc)
        choice = np.full(B, -1, np.int64)
        nallowed = m[rows, naive]
        nchoice = np.full(B, -1, np.int64)
        for v in vorder:
            pick = (choice < 0) & (allowed_next[:, v] > 0) \
                & (backs[:, h, v] > 0)
            choice[pick] = v
            npick = (nchoice < 0) & (nallowed[:, v] > 0)
            nchoice[npick] = v
        ok &= ~live | (choice >= 0)
        V[:, h] = np.where(live & (choice >= 0), choice, 0)
        ndead |= live & (nchoice < 0)
        naive = np.where(live & (nchoice >= 0), nchoice, naive)
    if not ok.all():
        if forbid_vc0:
            # no all-adaptive assignment exists: mark the whole flow as
            # escape-routed (VC0 from hop 0) -- always deliverable over
            # the escape tree, never deadlocks, just not adaptive
            V[~ok] = 0
            if stats is not None:
                stats["escape_fallback_flows"] = \
                    stats.get("escape_fallback_flows", 0) \
                    + int((~ok).sum())
        else:
            f = int(np.nonzero(~ok)[0][0])
            raise RuntimeError(f"path {P[f, :lens[f]].tolist()} has no "
                               f"valid VC assignment")
    if stats is not None:
        stats["greedy_dead_ends"] = stats.get("greedy_dead_ends", 0) \
            + int((ndead & (lens > 0)).sum())
    return V


def allocate_vcs(at: ATResult, table: Union[PathTable, CSRPathTable],
                 balance: bool = True, block: Optional[int] = None,
                 stats: Optional[dict] = None,
                 reserve_escape: bool = False) -> np.ndarray:
    """Fill the table's VC hops in place for every routed pair; returns
    the hops-per-VC counts ``(n_vc,)``.

    Flows are processed in blocks (row-major ``(s, d)`` order, as
    before); the priority VC is re-derived from the accumulated counts
    between blocks, so balancing tracks the reference policy at block
    granularity while every per-hop choice is one vectorised
    compatibility gather with exact lookahead (identical output to the
    old first-fit + per-flow DFS fallback, with the fallback frequency
    surfaced in ``stats['greedy_dead_ends']`` instead of paid for).

    ``reserve_escape`` keeps VC 0 free for the adaptive simulator's
    escape lane: every assignment uses VCs >= 1 only, and flows with no
    all-adaptive assignment are marked all-VC0 (escape-routed from
    injection; see :func:`_lookahead_vcs`). Requires ``n_vc >= 2``.
    """
    n_vc = at.n_vc
    if reserve_escape and n_vc < 2:
        raise ValueError("reserve_escape needs n_vc >= 2 (VC 0 is the "
                         "escape lane)")
    counts = np.zeros(n_vc, dtype=np.int64)
    csr = isinstance(table, CSRPathTable)
    if csr:
        F = table.n_flows
    else:
        ss, dd = np.nonzero(table.hops > 0)  # row-major == sorted (s, d)
        F = len(ss)
    if F == 0:
        return counts
    if block is None:
        block = max(64, F // 64) if balance else F
    for i in range(0, F, block):
        hi = min(i + block, F)
        if csr:
            P, _, lens = table.block_paths(i, hi)
        else:
            sb, db = ss[i:hi], dd[i:hi]
            lens = table.hops[sb, db].astype(np.int64)
            P = table.path[sb, db, :int(lens.max())].astype(np.int64)
        if reserve_escape:
            pr = 1 + int(np.argmin(counts[1:])) if balance else 1
            vorder = [pr] + [v for v in range(1, n_vc) if v != pr]
        else:
            pr = int(np.argmin(counts)) if balance else 0
            vorder = [pr] + [v for v in range(n_vc) if v != pr]
        V = _lookahead_vcs(at, P, lens, vorder, stats=stats,
                           forbid_vc0=reserve_escape)
        live = np.arange(P.shape[1])[None, :] < lens[:, None]
        if csr:
            table.set_block_vcs(i, hi, V, lens)
        else:
            table.vcs[sb, db, :P.shape[1]] = \
                np.where(live, V, 0).astype(np.int8)
        counts += np.bincount(V[live], minlength=n_vc)
    return counts


def reallocate_vcs(at: ATResult, table: CSRPathTable, flows: np.ndarray,
                   counts: np.ndarray, block: Optional[int] = None,
                   stats: Optional[dict] = None) -> np.ndarray:
    """Streamed VC re-allocation for an arbitrary flow subset.

    The fault-repair pipeline re-routes only the flows whose paths
    crossed dead channels; their old VC hops are stale (new channel
    sequences) while every untouched flow's assignment remains valid
    against the pruned allowed set (pruning only removes turns, never
    changes surviving ones). This re-runs the exact-lookahead assignment
    over just those ``flows`` -- the caller must already have subtracted
    their old hops from ``counts`` (the live hops-per-VC vector) so the
    balanced priority derivation sees the true background. ``counts`` is
    updated in place and returned.
    """
    flows = np.asarray(flows, np.int64)
    # zero-length (lost) flow slots have no hops to assign; tolerate
    # them so degraded-mode callers can pass a raw pool
    flows = flows[(table.hop_indptr[flows + 1]
                   - table.hop_indptr[flows]) > 0]
    n_vc = at.n_vc
    F = len(flows)
    if F == 0:
        return counts
    if block is None:
        block = max(64, F // 64)
    for i in range(0, F, block):
        sub = flows[i:min(i + block, F)]
        P, _, lens = table.gather_paths(sub)
        pr = int(np.argmin(counts))
        vorder = [pr] + [v for v in range(n_vc) if v != pr]
        V = _lookahead_vcs(at, P, lens, vorder, stats=stats)
        live = np.arange(P.shape[1])[None, :] < lens[:, None]
        table.set_flow_vcs(sub, V, lens)
        counts += np.bincount(V[live], minlength=n_vc)
    return counts


def verify_flows_deadlock_free(at: ATResult, table: CSRPathTable,
                               flows: np.ndarray) -> bool:
    """Deadlock-freedom check restricted to ``flows``: every consecutive
    (channel, vc) hop must be an allowed turn. The repair/restore paths
    use it pool-scoped -- untouched flows need no re-check because their
    paths cross no dead channel, so every turn they use survives pruning
    verbatim. Zero-length (lost) flows contribute no hop pairs and pass
    vacuously."""
    sg = at.state_graph()
    P, V, lens = table.gather_paths(flows)
    if P.shape[1] < 2:
        return True
    s = P * at.n_vc + V
    m = np.arange(P.shape[1] - 1)[None, :] < (lens - 1)[:, None]
    return bool(sg.has_edges(s[:, :-1][m], s[:, 1:][m]).all())


def verify_deadlock_free(at: ATResult,
                         table: Union[PathTable, CSRPathTable]) -> bool:
    """Invariant check: every consecutive (channel, vc) hop of every routed
    flow is an allowed turn => the union of dependencies is a subgraph of
    the acyclic allowed-turn CDG => deadlock-free. One batched membership
    test over every hop pair of every flow."""
    sg = at.state_graph()
    n_vc = at.n_vc
    if isinstance(table, CSRPathTable):
        s = table.chan.astype(np.int64) * n_vc + table.vc
        if len(s) < 2:
            return True
        # consecutive positions within one flow: drop the pairs that
        # straddle a flow boundary. Zero-length (lost) flows put boundaries
        # at 0 or len(s), which border no pair: the JAX package's version
        # indexes past the mask on a trailing lost flow and drops the last
        # pair on a leading one.
        m = np.ones(len(s) - 1, bool)
        starts = table.hop_indptr[1:-1]
        starts = starts[(starts > 0) & (starts < len(s))]
        m[starts - 1] = False
        return bool(sg.has_edges(s[:-1][m], s[1:][m]).all())
    from repro_torch.core.pathtable import MAXHOP
    ss, dd = np.nonzero(table.hops > 1)
    if len(ss) == 0:
        return True
    P = table.path[ss, dd].astype(np.int64)
    V = table.vcs[ss, dd].astype(np.int64)
    pair_ok = (np.arange(MAXHOP - 1)[None, :]
               < table.hops[ss, dd][:, None] - 1)
    a = (P[:, :-1] * n_vc + V[:, :-1])[pair_ok]
    b = (P[:, 1:] * n_vc + V[:, 1:])[pair_ok]
    return bool(sg.has_edges(a, b).all())
