"""Packed-array path representations for the routing -> simulation pipeline.

Port copy of ``repro.core.pathtable``: numpy on the host, unchanged.

``PathTable`` is the dense path/VC representation produced by path
selection (`routing.select_paths`), DOR construction (`netsim.dor_paths`)
and VC allocation (`vcalloc.allocate_vcs`), and consumed directly by the
cycle-level simulator (`netsim.build_tables`). It packs every (src, dst)
channel sequence into dense arrays:

    path: (n, n, MAXHOP) int32   channel ids along the route, -1 padded
    vcs:  (n, n, MAXHOP) int8    per-hop virtual-channel assignment
    hops: (n, n)         int32   route length (0 = unrouted / self)

The arrays are built incrementally (no intermediate ``Dict[(s, d), tuple]``
structures on the hot path) and all aggregate statistics -- per-channel
loads, L_max, average hops -- are vectorised numpy reductions. Dict views
exist only as explicit API edges (:meth:`as_dicts` / :meth:`from_dicts`)
for interop and debugging.

``CSRPathTable`` is the packed sparse variant for large pods: the dense
layout allocates ``n * n * MAXHOP`` slots no matter how long routes
actually are (2.7 GB of channel ids alone at 16^3), while the CSR form
stores one entry per real hop -- per-source flow offsets, per-flow hop
offsets, and concatenated channel / VC arrays. It is what the streaming
per-source-shard selection engine emits, exposes the same statistics API,
and round-trips losslessly through :meth:`CSRPathTable.to_dense` /
:meth:`CSRPathTable.from_dense` (``build_tables`` accepts either form and
densifies lazily only when a simulator kernel actually needs the dense
gather tables).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

MAXHOP = 40


@dataclasses.dataclass
class PathTable:
    n: int                    # nodes
    n_ch: int                 # directed channels
    n_vc: int                 # virtual channels
    path: np.ndarray          # (n, n, MAXHOP) int32, -1 pad
    vcs: np.ndarray           # (n, n, MAXHOP) int8
    hops: np.ndarray          # (n, n) int32

    # ---- construction -----------------------------------------------------

    @staticmethod
    def empty(n: int, n_ch: int, n_vc: int = 2) -> "PathTable":
        return PathTable(
            n, n_ch, n_vc,
            path=np.full((n, n, MAXHOP), -1, np.int32),
            vcs=np.zeros((n, n, MAXHOP), np.int8),
            hops=np.zeros((n, n), np.int32))

    def copy(self) -> "PathTable":
        return PathTable(self.n, self.n_ch, self.n_vc, self.path.copy(),
                         self.vcs.copy(), self.hops.copy())

    def set_path(self, s: int, d: int, channels,
                 vcs: Optional[List[int]] = None) -> None:
        """Incremental single-pair fill (API edge / tests)."""
        L = min(len(channels), MAXHOP)
        self.path[s, d, :L] = channels[:L]
        self.hops[s, d] = L
        if vcs is not None:
            self.vcs[s, d, :L] = vcs[:L]

    def set_paths_batch(self, src: np.ndarray, dst: np.ndarray,
                        chan: np.ndarray, length: np.ndarray,
                        vcs: Optional[np.ndarray] = None) -> None:
        """Bulk fill: chan is (F, W) padded with -1 (or any negative);
        ``vcs`` (same shape) optionally sets per-hop VC assignments."""
        L = chan.shape[1]
        self.path[src, dst, :L] = np.where(chan < 0, -1, chan)
        self.hops[src, dst] = length
        if vcs is not None:
            live = np.arange(L)[None, :] < np.asarray(length)[:, None]
            self.vcs[src, dst, :L] = np.where(live, vcs, 0).astype(np.int8)

    # ---- vectorised statistics -------------------------------------------

    def routed_mask(self) -> np.ndarray:
        """(n, n) bool: pairs with a route (excludes self / unrouted)."""
        return self.hops > 0

    def n_routed(self) -> int:
        return int(self.routed_mask().sum())

    def nbytes(self) -> int:
        """Bytes held by the dense ``(n, n, MAXHOP)`` route arrays --
        the quantity the CSR layout's O(total routed hops) replaces."""
        return int(self.path.nbytes + self.vcs.nbytes + self.hops.nbytes)

    def loads(self) -> np.ndarray:
        """Per-channel load: number of routes crossing each channel."""
        used = self.path[self.path >= 0]
        return np.bincount(used, minlength=self.n_ch).astype(np.float64)

    def l_max(self) -> float:
        loads = self.loads()
        return float(loads.max()) if loads.size else 0.0

    def avg_hops(self) -> float:
        m = self.routed_mask()
        return float(self.hops[m].mean()) if m.any() else 0.0

    def vc_hop_counts(self) -> np.ndarray:
        """Hops assigned to each VC across all routes, (n_vc,)."""
        valid = self.path >= 0
        return np.bincount(self.vcs[valid].astype(np.int64),
                           minlength=self.n_vc)

    # ---- dict views (API edges only) -------------------------------------

    def as_dicts(self) -> Tuple[Dict[Tuple[int, int], Tuple[int, ...]],
                                Dict[Tuple[int, int], List[int]]]:
        """Materialise ``{(s, d): channel tuple}`` / ``{(s, d): vc list}``.

        O(n^2) python -- strictly an interop/debugging edge, never called
        on the routing -> simulation hot path.

        .. deprecated:: use the packed arrays.
           Dict views are confined to API edges; internal consumers read
           the packed arrays directly.
        """
        warnings.warn(
            "PathTable.as_dicts() is an interop/debugging edge and is "
            "deprecated for internal use; read the packed arrays "
            "(path/hops/vcs or the CSR fields) instead.",
            DeprecationWarning, stacklevel=2)
        paths: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        vcs: Dict[Tuple[int, int], List[int]] = {}
        ss, dd = np.nonzero(self.routed_mask())
        for s, d in zip(ss.tolist(), dd.tolist()):
            L = int(self.hops[s, d])
            paths[(s, d)] = tuple(int(c) for c in self.path[s, d, :L])
            vcs[(s, d)] = [int(v) for v in self.vcs[s, d, :L]]
        return paths, vcs

    @staticmethod
    def from_dicts(n: int, n_ch: int,
                   paths: Dict[Tuple[int, int], Tuple[int, ...]],
                   vcs: Optional[Dict[Tuple[int, int], List[int]]] = None,
                   n_vc: int = 2) -> "PathTable":
        """Interop edge for legacy dict-of-tuples producers."""
        t = PathTable.empty(n, n_ch, n_vc)
        for (s, d), p in paths.items():
            t.set_path(s, d, list(p), None if vcs is None else vcs[(s, d)])
        return t


# ---------------------------------------------------------------------------
# Packed CSR variant: per-source flow offsets + concatenated hop arrays
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSRPathTable:
    """Sparse path/VC table: memory scales with total routed hops, not
    ``n^2 * MAXHOP``.

    Flows are stored in row-major ``(src, dst)`` order:

        src_indptr: (n + 1,)  int64   flow range of each source
        dst:        (F,)      int32   destination of each flow
        hop_indptr: (F + 1,)  int64   hop range of each flow
        chan:       (H,)      int32   concatenated channel ids
        vc:         (H,)      int8    concatenated per-hop VCs

    ``H`` is the total hop count over all routed flows. Unrouted pairs
    simply have no flow entry (self-pairs never do).
    """
    n: int
    n_ch: int
    n_vc: int
    src_indptr: np.ndarray
    dst: np.ndarray
    hop_indptr: np.ndarray
    chan: np.ndarray
    vc: np.ndarray

    # ---- construction -----------------------------------------------------

    def copy(self) -> "CSRPathTable":
        return CSRPathTable(self.n, self.n_ch, self.n_vc,
                            self.src_indptr.copy(), self.dst.copy(),
                            self.hop_indptr.copy(), self.chan.copy(),
                            self.vc.copy())

    @property
    def n_flows(self) -> int:
        return len(self.dst)

    @property
    def flow_src(self) -> np.ndarray:
        """(F,) source of each flow, expanded from the CSR offsets."""
        return np.repeat(np.arange(self.n, dtype=np.int32),
                         np.diff(self.src_indptr))

    @property
    def flow_len(self) -> np.ndarray:
        """(F,) hop count of each flow."""
        return np.diff(self.hop_indptr).astype(np.int32)

    @property
    def hops(self) -> np.ndarray:
        """Dense ``(n, n)`` hop-count matrix (API-edge parity with the
        dense table; materialised per access -- don't call in loops)."""
        h = np.zeros((self.n, self.n), np.int32)
        h[self.flow_src, self.dst] = self.flow_len
        return h

    @staticmethod
    def from_dense(t: PathTable) -> "CSRPathTable":
        """Pack a dense table; exact inverse of :meth:`to_dense`."""
        ss, dd = np.nonzero(t.hops > 0)             # row-major == sorted
        lens = t.hops[ss, dd].astype(np.int64)
        hop_indptr = np.zeros(len(ss) + 1, np.int64)
        np.cumsum(lens, out=hop_indptr[1:])
        W = int(lens.max()) if len(lens) else 1
        live = np.arange(W)[None, :] < lens[:, None]
        return CSRPathTable(
            t.n, t.n_ch, t.n_vc,
            src_indptr=np.searchsorted(ss, np.arange(t.n + 1)
                                       ).astype(np.int64),
            dst=dd.astype(np.int32),
            hop_indptr=hop_indptr,
            chan=t.path[ss, dd, :W][live].astype(np.int32),
            vc=t.vcs[ss, dd, :W][live].astype(np.int8))

    def to_dense(self) -> PathTable:
        """Materialise the dense ``(n, n, MAXHOP)`` form (simulator
        kernels gather from it; large pods should stay CSR until then)."""
        t = PathTable.empty(self.n, self.n_ch, self.n_vc)
        lens = self.flow_len.astype(np.int64)
        if not len(lens):
            return t
        ss = self.flow_src.astype(np.int64)
        dd = self.dst.astype(np.int64)
        pos = np.arange(len(self.chan)) - np.repeat(self.hop_indptr[:-1],
                                                    lens)
        fs, fd = np.repeat(ss, lens), np.repeat(dd, lens)
        t.path[fs, fd, pos] = self.chan
        t.vcs[fs, fd, pos] = self.vc
        t.hops[ss, dd] = lens
        return t

    # ---- block access (vcalloc / verification hot path) -------------------

    def block_paths(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
        """Flows ``lo:hi`` as padded arrays: ``(chan (B, W), vc (B, W),
        lens (B,))``; ``chan`` padded with -1."""
        lens = np.diff(self.hop_indptr[lo:hi + 1]).astype(np.int64)
        B = hi - lo
        W = int(lens.max()) if B and lens.size else 1
        P = np.full((B, W), -1, np.int64)
        V = np.zeros((B, W), np.int8)
        pos = np.arange(W)[None, :]
        live = pos < lens[:, None]
        idx = self.hop_indptr[lo:hi, None] + pos
        P[live] = self.chan[idx[live]]
        V[live] = self.vc[idx[live]]
        return P, V, lens

    def set_block_vcs(self, lo: int, hi: int, V: np.ndarray,
                      lens: np.ndarray) -> None:
        """Write padded per-hop VCs ``V (B, W)`` back for flows
        ``lo:hi``."""
        W = V.shape[1]
        pos = np.arange(W)[None, :]
        live = pos < lens[:, None]
        idx = self.hop_indptr[lo:hi, None] + pos
        self.vc[idx[live]] = V[live].astype(np.int8)

    def gather_paths(self, flows: np.ndarray) -> Tuple[np.ndarray,
                                                       np.ndarray,
                                                       np.ndarray]:
        """Arbitrary flow subset as padded arrays -- the scatter/gather
        twin of :meth:`block_paths` for non-contiguous flow pools (the
        fault-repair re-route touches exactly the flows crossing dead
        channels, which are spread across every source). Returns
        ``(chan (B, W), vc (B, W), lens (B,))``, ``chan`` -1-padded."""
        flows = np.asarray(flows, np.int64)
        lens = (self.hop_indptr[flows + 1]
                - self.hop_indptr[flows]).astype(np.int64)
        B = len(flows)
        W = int(lens.max()) if B and lens.size else 1
        P = np.full((B, W), -1, np.int64)
        V = np.zeros((B, W), np.int8)
        pos = np.arange(W)[None, :]
        live = pos < lens[:, None]
        idx = self.hop_indptr[flows, None] + pos
        P[live] = self.chan[idx[live]]
        V[live] = self.vc[idx[live]]
        return P, V, lens

    def set_flow_vcs(self, flows: np.ndarray, V: np.ndarray,
                     lens: np.ndarray) -> None:
        """Write padded per-hop VCs ``V (B, W)`` back for an arbitrary
        flow subset (twin of :meth:`set_block_vcs`)."""
        flows = np.asarray(flows, np.int64)
        W = V.shape[1]
        pos = np.arange(W)[None, :]
        live = pos < lens[:, None]
        idx = self.hop_indptr[flows, None] + pos
        self.vc[idx[live]] = V[live].astype(np.int8)

    def compact(self) -> Tuple["CSRPathTable", np.ndarray]:
        """Drop zero-length (lost) flows; returns ``(table, kept)`` with
        ``kept`` mapping new flow ids back to old ones.

        Degraded-mode serving (:func:`repro.core.repair.repair_fault`
        with ``on_disconnect="degrade"``) keeps disconnected pairs as
        zero-length flow slots so flow ids stay stable across
        fault/restore events. The simulator samples traffic over flow
        slots and cannot inject a packet with no route, so throughput
        probes of a degraded fabric run on the compacted table."""
        lens = self.flow_len.astype(np.int64)
        kept = np.nonzero(lens > 0)[0]
        if len(kept) == len(lens):
            return self.copy(), kept
        src = self.flow_src.astype(np.int64)[kept]
        src_indptr = np.searchsorted(src,
                                     np.arange(self.n + 1)).astype(np.int64)
        hop_indptr = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(lens[kept], out=hop_indptr[1:])
        # zero-length flows contribute no hops, so the concatenated
        # chan/vc arrays are already exactly the compacted ones
        return CSRPathTable(self.n, self.n_ch, self.n_vc, src_indptr,
                            self.dst[kept].copy(), hop_indptr,
                            self.chan.copy(), self.vc.copy()), kept

    # ---- vectorised statistics (PathTable API parity) ---------------------

    def routed_mask(self) -> np.ndarray:
        m = np.zeros((self.n, self.n), bool)
        live = self.flow_len > 0
        m[self.flow_src[live], self.dst[live]] = True
        return m

    def n_routed(self) -> int:
        """Flows with an actual route -- zero-length (lost) flow slots
        kept by degraded-mode serving don't count as routed."""
        return int((self.flow_len > 0).sum())

    def nbytes(self) -> int:
        """Bytes held by the packed CSR arrays (O(total routed hops))."""
        return int(self.src_indptr.nbytes + self.dst.nbytes
                   + self.hop_indptr.nbytes + self.chan.nbytes
                   + self.vc.nbytes)

    def loads(self) -> np.ndarray:
        return np.bincount(self.chan,
                           minlength=self.n_ch).astype(np.float64)

    def l_max(self) -> float:
        loads = self.loads()
        return float(loads.max()) if loads.size else 0.0

    def avg_hops(self) -> float:
        lens = self.flow_len
        lens = lens[lens > 0]
        return float(lens.mean()) if len(lens) else 0.0

    def vc_hop_counts(self) -> np.ndarray:
        return np.bincount(self.vc.astype(np.int64), minlength=self.n_vc)

    def escape_flows(self) -> np.ndarray:
        """Flow ids an escape-reserving VC allocation marked all-VC0
        (:func:`repro.core.vcalloc.allocate_vcs` with
        ``reserve_escape=True`` assigns VCs >= 1 everywhere else), i.e.
        the flows the adaptive kernel escape-routes from injection.
        Only meaningful on such tables -- on a normal allocation this
        simply returns the flows that happen to ride VC0 end to end."""
        lens = self.flow_len.astype(np.int64)
        nz = np.nonzero(lens > 0)[0]
        if not len(nz):
            return nz
        vmax = np.maximum.reduceat(self.vc.astype(np.int64),
                                   self.hop_indptr[nz])
        return nz[vmax == 0]

    # ---- dict views (API edges only) --------------------------------------

    def as_dicts(self) -> Tuple[Dict[Tuple[int, int], Tuple[int, ...]],
                                Dict[Tuple[int, int], List[int]]]:
        """.. deprecated:: see :meth:`PathTable.as_dicts`."""
        warnings.warn(
            "CSRPathTable.as_dicts() is an interop/debugging edge and is "
            "deprecated for internal use; read the CSR arrays "
            "(hop_indptr/chan/vc/dst) instead.",
            DeprecationWarning, stacklevel=2)
        paths: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        vcs: Dict[Tuple[int, int], List[int]] = {}
        src = self.flow_src
        for f in range(self.n_flows):
            lo, hi = int(self.hop_indptr[f]), int(self.hop_indptr[f + 1])
            key = (int(src[f]), int(self.dst[f]))
            paths[key] = tuple(int(c) for c in self.chan[lo:hi])
            vcs[key] = [int(v) for v in self.vc[lo:hi]]
        return paths, vcs
