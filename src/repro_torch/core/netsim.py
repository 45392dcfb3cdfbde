"""Cycle-level network simulator in torch: port of ``repro.core.netsim``'s
static CSR kernel, bit-exact to it.

Same semantics as the reference (see its module docstring): per-(channel,
VC) ring buffers of packed packet words, round-robin VC arbitration, one
packet serviced per channel per cycle, one push per target queue per
cycle (the lowest channel id wins), alias-sampled injection over each
source's routed flows, the watchdog, and exact conservation counters.
All injection rates of a sweep run together as lane-flattened
simulations, and the counters equal the reference's for the same tables,
traffic and seed -- on the CPU and on the GPU alike:

- the random stream is JAX's own (:mod:`repro_torch.core.prng`). The key
  chain depends only on the seed, so it is walked once on the host and
  the draws of a whole block of cycles come from one vectorised pass on
  the device;
- ``.at[...](mode="drop")`` scatters land in one padding row (index
  ``NQ``) of the queue state instead of being dropped;
- the early stop (every lane stalled by the watchdog) is exact without a
  host sync per cycle: a block's state is kept at its start, the device
  records each cycle's all-stalled flag, and when a block saw a stop the
  block is replayed from the kept state up to that cycle.

Ported here: the static tables (``dor_tables``, ``at_tables``), every
traffic pattern (stationary, bursty, phased, multi-tenant),
``sweep``/``run``/``saturation_point`` with adaptive escape-VC routing
(``adaptive_spec``) and mid-sweep faults, and the dense oracle kernel
(``kernel="dense"``). The extension modes are host-static branches of
one cycle body, as the reference's flags are python-static, so the
static cycle's ops are unchanged by them; the fault plane and the demand
phase depend only on the cycle number, which the host holds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.pathtable import MAXHOP, CSRPathTable, PathTable
from repro_torch.core.routing import (ATResult, Channels, RoutingResult,
                                      _dead_channel_array)
from repro_torch.core.topology import Topology
from repro_torch.core.traffic import (CompiledFlowTraffic, CompiledTraffic,
                                      PhasedTraffic, TrafficPattern,
                                      compile_flow_traffic)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SimTables:
    """Static routing tables for the simulator (either path-table layout,
    kept as-is in ``table``; conversions are cached on the side)."""
    n: int
    n_ch: int
    n_vc: int
    ch_dst: np.ndarray                  # (C,)
    table: Union[PathTable, CSRPathTable]
    _dense_cache: Optional[PathTable] = \
        dataclasses.field(default=None, repr=False)
    _csr_cache: Optional[CSRPathTable] = \
        dataclasses.field(default=None, repr=False)

    def dense(self) -> PathTable:
        if isinstance(self.table, PathTable):
            return self.table
        if self._dense_cache is None:
            self._dense_cache = self.table.to_dense()
        return self._dense_cache

    def csr(self) -> CSRPathTable:
        if isinstance(self.table, CSRPathTable):
            return self.table
        if self._csr_cache is None:
            self._csr_cache = CSRPathTable.from_dense(self.table)
        return self._csr_cache

    @property
    def path(self) -> np.ndarray:
        return self.dense().path

    @property
    def vcs(self) -> np.ndarray:
        return self.dense().vcs

    @property
    def hops(self) -> np.ndarray:
        return self.dense().hops


def build_tables(topo: Topology,
                 table: Union[PathTable, CSRPathTable, RoutingResult]
                 ) -> SimTables:
    """Packed path table (or a RoutingResult carrying one) -> SimTables."""
    if isinstance(table, RoutingResult):
        table = table.table
    ch = Channels.from_topology(topo)
    if table.n_ch != ch.n:
        raise ValueError(f"table built for {table.n_ch} channels, "
                         f"topology has {ch.n}")
    return SimTables(table.n, ch.n, table.n_vc, ch.dst.astype(np.int32),
                     table)


# Packet words (one int64 per packet, holding the reference's int32
# layouts):
#   csr kernel:    flow[0:24] | hop[24:30] | tag[30]
#   dense kernel:  src[0:12] | dst[12:24] | hop[24:30] | tag[30]  (n <= 4095)
_DST_SHIFT = 12
_HOP_SHIFT = 24
_TAG_SHIFT = 30
_FIELD_MASK = (1 << 12) - 1
_HOP_MASK = (1 << 6) - 1
_FLOW_MASK = (1 << 24) - 1

_BLOCK = 256          # cycles per block of draws / stop check


@dataclasses.dataclass
class AdaptiveSpec:
    """Precomputed adaptive-routing tables for the sweep.

    ``esc``/``minmask`` are stacked (2, n, n): plane 0 is the pre-fault
    network, plane 1 the post-fault survivors (identical when no fault is
    injected). ``outch`` is the fixed per-node out-channel slot layout --
    CSR out-adjacency order, fault-independent, so ``minmask`` bit ``j``
    always refers to the same physical channel.
    """
    esc: np.ndarray       # (2, n, n) int32: escape next-channel, -1 none
    outch: np.ndarray     # (n, D) int32: out-channels per node, -1 pad
    minmask: np.ndarray   # (2, n, n) uint8: bit j <=> outch[u, j] minimal

    @property
    def D(self) -> int:
        return self.outch.shape[1]


def adaptive_spec(topo: Topology, dead_channels=None) -> AdaptiveSpec:
    """Build the escape + minimal-alternate tables for adaptive sweeps.

    When ``dead_channels`` is given, plane 1 of the stacked tables is
    recomputed over the survivors (escape tree re-rooted around the
    fault, minimal masks re-derived from surviving distances) -- the
    sweep switches planes at the fault cycle.
    """
    from repro_torch.core.routing import adaptive_route
    from repro_torch.core.vcalloc import escape_routes
    e0 = escape_routes(topo)
    a0 = adaptive_route(topo)
    if not e0.connected:
        raise ValueError("pre-fault escape tree does not span the "
                         "network")
    dc = _dead_channel_array(dead_channels)
    if dc is None:
        e1, a1 = e0, a0
    else:
        e1 = escape_routes(topo, dc)
        a1 = adaptive_route(topo, dc)
    return AdaptiveSpec(
        np.stack([e0.esc_next, e1.esc_next]).astype(np.int32),
        a0.outch.astype(np.int32),
        np.stack([a0.minmask, a1.minmask]).astype(np.uint8))


class _Sim:
    """One lane-flattened sweep: R simulations (one per rate). Lane
    ``l``'s queue (c, v) is flat row ``l * n_ch * n_vc + c * n_vc + v``;
    row ``NQ`` is the padding row that takes every dropped write.

    ``route`` holds the CSR hop arrays (``pvf``, ``hptr``, ``lenm1``,
    ``dstN``) or, with ``dense``, the flat ``(n, n, MAXHOP)`` composite
    table ``pv`` and flow -> destination ``fdst``. The extension modes
    are host-static branches, as the reference's flags are
    python-static, so the static cycle issues exactly its own ops:

    - ``adaptive`` (an :class:`AdaptiveSpec`): minimal adaptive routing
      with the VC 0 escape tree and the per-queue ``stall`` counter;
    - ``fault=(t_fault, alive)``: ``alive`` is the (2, n_ch) pre/post
      plane, chosen on the host from the cycle number;
    - ``gain`` (period, N): the bursty threshold gain of each source at
      each cycle of the period;
    - ``phase_of``: the demand phase of each cycle of the schedule
      (``fprob``/``falias``/``thresh`` then carry a leading phase axis);
    - ``tenants=(T, tof, tmap)``: per-(lane, tenant) counters.
    """

    def __init__(self, route, src_ptr, deg, fprob, falias, thresh, *, R,
                 n, n_ch, n_vc, slots, warmup, flits, watchdog, device,
                 dense=False, ch_dst=None, adaptive=None, patience=64,
                 fault=None, gain=None, phase_of=None, tenants=None):
        i64 = dict(dtype=torch.int64, device=device)
        self.R, self.n, self.n_ch, self.n_vc = R, n, n_ch, n_vc
        self.slots, self.warmup, self.flits = slots, warmup, flits
        self.watchdog, self.patience, self.dense = watchdog, patience, dense
        self.C = C = R * n_ch
        self.NQ = NQ = C * n_vc
        self.N = N = R * n
        for k, v in route.items():
            setattr(self, k, torch.as_tensor(v, device=device))
        self.fprob = torch.as_tensor(fprob, device=device)
        self.falias = torch.as_tensor(falias, device=device)
        self.thresh = torch.as_tensor(thresh, device=device)
        self.H = len(route["pvf"]) if not dense else 0
        self.F = fprob.shape[-1]
        per_lane = n_ch * n_vc
        self.ar_c = torch.arange(C, **i64)
        self.ar_vc = torch.arange(n_vc, **i64)
        self.row_base = torch.arange(NQ, **i64) * slots
        self.lane_base = (torch.arange(NQ, **i64) // per_lane) * per_lane
        ar_n = torch.arange(N, **i64)
        self.srcs = ar_n % n
        self.lane_q = (ar_n // n) * per_lane
        self.dg = torch.as_tensor(deg, device=device)[self.srcs]
        self.dgf = self.dg.to(torch.float32)
        self.sptr = torch.as_tensor(src_ptr, device=device)[self.srcs]
        self.m1 = torch.full((C,), -1, **i64)
        self.ones = torch.ones(C + N, **i64)
        if dense or adaptive is not None:
            # the node each queue's channel arrives at
            self.node_q = torch.as_tensor(ch_dst, **i64).repeat(R)\
                .repeat_interleave(n_vc)
        # fault: alive planes and the cycle the post-fault one takes over
        self.alive = None
        if fault is not None:
            self.t_fault = fault[0]
            self.alive = torch.as_tensor(fault[1], device=device)
        self.gain = None if gain is None else \
            torch.as_tensor(gain, device=device)
        self.phase_of = phase_of
        self.T = 0
        if tenants is not None:
            self.T, tof, tmap = tenants
            self.tof = torch.as_tensor(tof, **i64)
            self.tmap = torch.as_tensor(tmap, **i64).reshape(-1)
            self.lane_c_t = (self.ar_c // n_ch) * self.T
            self.lane_n_t = (ar_n // n) * self.T
        self.adp = adaptive is not None
        if self.adp:
            self._init_adaptive(adaptive, i64)
        # state
        self.q = torch.zeros((NQ + 1) * slots, **i64)   # flat ring buffers
        self.head = torch.zeros(NQ + 1, **i64)
        self.size = torch.zeros(NQ + 1, **i64)
        self.rr = torch.zeros(C, **i64)
        self.busy = torch.zeros(C, **i64)
        # offered, accepted, tagged, consumed_meas, consumed, injected
        self.stats = torch.zeros((6, R), **i64)
        self.wstall = torch.zeros(R, **i64)
        self.stalled_at = torch.full((R,), -1, **i64)
        self._state = list(self._STATE)
        if self.adp:
            self.stall = torch.zeros(NQ, **i64)     # per-queue stall
            self.escaped = torch.zeros(R, **i64)
            self._state += ["stall", "escaped"]
        if self.T:
            # injected, consumed, consumed in the window per (lane, tenant)
            self.inj_t = torch.zeros(R * self.T, **i64)
            self.cons_t = torch.zeros(R * self.T, **i64)
            self.consm_t = torch.zeros(R * self.T, **i64)
            self._state += ["inj_t", "cons_t", "consm_t"]

    _STATE = ("q", "head", "size", "rr", "busy", "stats", "wstall",
              "stalled_at")

    def _init_adaptive(self, spec: AdaptiveSpec, i64):
        """Per-queue constants of the adaptive step: everything the
        reference recomputes each cycle that depends only on the queue,
        the plane or the cycle modulo D."""
        NQ, n, n_ch, n_vc = self.NQ, self.n, self.n_ch, self.n_vc
        D = self.D = spec.D
        self.esc = torch.as_tensor(spec.esc, **i64).reshape(2, -1)
        self.minmask = torch.as_tensor(spec.minmask, **i64).reshape(2, -1)
        qrows = torch.arange(NQ, **i64)
        self.qrows_cv = qrows.view(self.C, n_vc)
        self.vc0 = qrows % n_vc == 0
        self.my_ch = (qrows // n_vc) % n_ch
        self.node_n = self.node_q * n                   # row of (node, .)
        self.srcs_n = self.srcs * n
        self.ar_d = torch.arange(D, **i64)
        outch = torch.as_tensor(spec.outch, **i64)
        self.cand_ch = outch[self.node_q].clamp(0, n_ch - 1)   # (NQ, D)
        self.cand_q = self.lane_base[:, None] + self.cand_ch * n_vc
        # rotating tie-break of cycle i: rot[i % D]
        self.rot = torch.stack([(self.ar_d[None, :] + qrows[:, None] + r) % D
                                for r in range(D)])
        if self.alive is not None:
            self.cand_alive = self.alive[:, self.cand_ch]   # (2, NQ, D)

    def save(self):
        return {k: getattr(self, k).clone() for k in self._state}

    def restore(self, saved):
        for k, v in saved.items():
            setattr(self, k, v)

    # ---- routing of the head packets ---------------------------------------

    def _adaptive_target(self, i, ph, nonempty, consume_q, size, dq,
                         on_path, chan_s):
        """The adaptive next queue of every head (``-1``: none): the
        planned hop while its destination-bound queue has room, else the
        freest live minimal alternate, else (and on VC 0, or after
        ``patience`` stalled cycles) the escape tree."""
        NQ, n_ch, n_vc, slots, D = (self.NQ, self.n_ch, self.n_vc,
                                    self.slots, self.D)
        mm = self.minmask[ph][self.node_n + dq]
        ok_cand = ((mm[:, None] >> self.ar_d[None, :]) & 1) > 0
        if self.alive is not None:
            ok_cand = ok_cand & self.cand_alive[ph]
        # destination-bound adaptive VC and its free space per candidate
        bv = 1 + dq % (n_vc - 1)
        occ = size[self.cand_q + bv[:, None]]
        score = torch.where(ok_cand, slots - occ, -1)
        j = torch.argmax(score * D + self.rot[i % D], dim=1)[:, None]
        best_score = score.gather(1, j)[:, 0]
        best_ch = self.cand_ch.gather(1, j)[:, 0]
        has_cand = best_score >= 0
        # planned-path-first
        prim_occ = size[self.lane_base + chan_s * n_vc + bv]
        best_occ = slots - best_score           # slots + 1 when no cand
        prim_take = on_path & ~consume_q & (prim_occ < slots) \
            & (prim_occ <= best_occ + 4)
        if self.alive is not None:
            prim_take = prim_take & self.alive[ph][chan_s]
        use_esc = self.vc0 | (self.stall >= self.patience) \
            | (~has_cand & ~prim_take)
        e_ch = self.esc[ph][self.node_n + dq]
        nxt_ch = torch.where(use_esc, e_ch,
                             torch.where(prim_take, chan_s, best_ch))
        nxt_vc = torch.where(use_esc, 0, bv)
        valid = nxt_ch >= 0
        nxt_c = nxt_ch.clamp(0, n_ch - 1)
        if self.alive is not None:
            valid = valid & self.alive[ph][nxt_c]
        tq = torch.where(consume_q | ~valid, -1,
                         self.lane_base + nxt_c * n_vc + nxt_vc)
        fwd_ok = nonempty & ~consume_q & (tq >= 0) \
            & (size[tq.clamp(0, NQ - 1)] < slots)
        return tq, fwd_ok

    def _route_csr(self, i, ph, hw, nonempty, size):
        NQ, slots, H = self.NQ, self.slots, self.H
        hf = hw & _FLOW_MASK
        hh = (hw >> _HOP_SHIFT) & _HOP_MASK
        if self.adp:
            # consume on destination arrival (adaptive paths leave the
            # table); the static hop is the planned one
            dq = self.dstN[hf]
            consume_q = nonempty & (self.node_q == dq)
            hp = self.hptr[hf] + hh
            on_path = (hh <= self.lenm1[hf]) \
                & (self.pvf[hp.clamp(max=H - 1)] // self.n_vc == self.my_ch)
            chan_s = self.pvf[(hp + 1).clamp(max=H - 1)] // self.n_vc
            tq, fwd_ok = self._adaptive_target(i, ph, nonempty, consume_q,
                                               size, dq, on_path, chan_s)
            return consume_q, tq, fwd_ok
        consume_q = nonempty & (hh == self.lenm1[hf])
        nxt = self.pvf[torch.clamp(self.hptr[hf] + hh + 1, max=H - 1)]
        tq = torch.where(consume_q, -1, self.lane_base + nxt)
        if self.alive is not None:
            # dead next hop: the packet waits in place
            tq = torch.where(self.alive[ph][nxt // self.n_vc], tq, -1)
            fwd_ok = nonempty & ~consume_q & (tq >= 0) \
                & (size[tq.clamp(0, NQ - 1)] < slots)
        else:
            fwd_ok = nonempty & ~consume_q \
                & (size[tq.clamp(0, NQ - 1)] < slots)
        return consume_q, tq, fwd_ok

    def _route_dense(self, i, ph, hw, nonempty, size):
        """The dense oracle: routes from the (n, n, MAXHOP) table by the
        (src, dst) the word carries; consumption on destination arrival.
        Hop indices past the table clamp to its last column, as the
        reference's gathers clamp."""
        NQ, slots, n, n_ch, n_vc = (self.NQ, self.slots, self.n, self.n_ch,
                                    self.n_vc)
        hs = hw & _FIELD_MASK
        hd = (hw >> _DST_SHIFT) & _FIELD_MASK
        hh = (hw >> _HOP_SHIFT) & _HOP_MASK
        consume_q = nonempty & (self.node_q == hd)
        base = (hs * n + hd) * MAXHOP
        pnxt = self.pv[base + (hh + 1).clamp(max=MAXHOP - 1)]
        if self.adp:
            pcur = self.pv[base + hh.clamp(max=MAXHOP - 1)]
            on_path = (pcur >= 0) & (pcur // n_vc == self.my_ch) \
                & (pnxt >= 0)
            chan_s = pnxt.clamp(0, n_ch * n_vc - 1) // n_vc
            tq, fwd_ok = self._adaptive_target(i, ph, nonempty, consume_q,
                                               size, hd, on_path, chan_s)
            return consume_q, tq, fwd_ok
        tq = torch.where(consume_q, -1, self.lane_base + pnxt)
        if self.alive is not None:
            # a -1 entry (past the path's end) wraps, as in the reference
            tq = torch.where(self.alive[ph][pnxt // n_vc], tq, -1)
            fwd_ok = nonempty & ~consume_q & (tq >= 0) \
                & (size[tq.clamp(0, NQ - 1)] < slots)
        else:
            fwd_ok = nonempty & ~consume_q \
                & (size[tq.clamp(0, NQ - 1)] < slots)
        return consume_q, tq, fwd_ok

    def _first_queue(self, ph, fid):
        """The queue each source's sampled flow is injected into, and
        (adaptive or faulted) whether that injection may happen at all."""
        n_ch, n_vc = self.n_ch, self.n_vc
        fidc = fid.clamp(max=self.F - 1)        # sources without flows
        if self.dense:
            dsts = self.fdst[fidc]
            cv0 = self.pv[(self.srcs * self.n + dsts) * MAXHOP]
            cv0 = cv0.clamp(0, n_ch * n_vc - 1)
        else:
            dsts = None
            cv0 = self.pvf[self.hptr[fidc]]
        ok0 = None
        if self.adp or self.alive is not None:
            ch0 = cv0 // n_vc
            if self.alive is not None:
                ok0 = self.alive[ph][ch0]
            if self.adp:
                # onto the planned channel's destination-bound VC; planned
                # first hop dead: straight onto the escape tree
                dstf = dsts if self.dense else self.dstN[fidc]
                iv = 1 + dstf % (n_vc - 1)
                if ok0 is None:
                    cv0 = ch0 * n_vc + iv
                else:
                    e0 = self.esc[ph][self.srcs_n + dstf]
                    cv0 = torch.where(ok0, ch0 * n_vc + iv,
                                      e0.clamp(min=0) * n_vc)
                    ok0 = ok0 | (e0 >= 0)
        return self.lane_q + cv0, ok0, dsts, fidc

    def cycle(self, i: int, u_want, u1, u2) -> torch.Tensor:
        """One cycle (``netsim._sweep_csr``'s body, or ``_sweep_dense``'s
        with ``dense``); returns the device flag "every lane is stalled"
        after it."""
        NQ, C, R, n, n_ch, n_vc = (self.NQ, self.C, self.R, self.n,
                                    self.n_ch, self.n_vc)
        slots = self.slots
        size = self.size[:NQ]
        ph = int(i >= self.t_fault) if self.alive is not None else 0
        phz = None if self.phase_of is None \
            else int(self.phase_of[i % len(self.phase_of)])

        # ---- head packet per (lane, channel, vc) --------------------------
        hw = self.q[self.row_base + self.head[:NQ]]
        nonempty = size > 0
        route = self._route_dense if self.dense else self._route_csr
        consume_q, tq, fwd_ok = route(i, ph, hw, nonempty, size)

        # ---- round-robin arbitration: one vc per channel ------------------
        eligible = (consume_q | fwd_ok) \
            & (self.busy == 0).repeat_interleave(n_vc)
        offs = (self.rr[:, None] + self.ar_vc[None, :]) % n_vc
        pri = eligible.view(C, n_vc).gather(1, offs)
        first = pri.to(torch.int8).argmax(dim=1)   # first eligible
        any_e = pri.any(dim=1)
        win_v = (self.rr + first) % n_vc
        win_q = self.ar_c * n_vc + win_v
        self.rr = torch.where(any_e, (win_v + 1) % n_vc, self.rr)

        w_word = hw[win_q]
        w_tag = (w_word >> _TAG_SHIFT) & 1
        w_consume = consume_q[win_q] & any_e
        w_target = torch.where(any_e & ~w_consume, tq[win_q], -1)

        # ---- crossbar: one push per target queue, lowest channel wins -----
        cand = any_e & ~w_consume & (w_target >= 0)
        tgt = w_target.clamp(0, NQ - 1)
        firstq = torch.full((NQ + 1,), C, dtype=torch.int64,
                            device=tgt.device).scatter_reduce_(
            0, torch.where(cand, tgt, NQ), self.ar_c, "amin")
        w_push = cand & (firstq[tgt] == self.ar_c)
        w_pop = w_consume | w_push
        self.busy = torch.where(w_pop, self.flits - 1,
                                (self.busy - 1).clamp(min=0))
        p_slot = (self.head[tgt] + size[tgt]) % slots
        if self.adp:
            # adaptive paths are not bounded by the table: the 6-bit hop
            # field saturates instead of wrapping into the tag
            push_word = torch.where(
                ((w_word >> _HOP_SHIFT) & _HOP_MASK) >= _HOP_MASK, w_word,
                w_word + (1 << _HOP_SHIFT))
        else:
            push_word = w_word + (1 << _HOP_SHIFT)    # hop += 1

        # ---- injection: alias-sampled routed flow per source --------------
        measure = i >= self.warmup
        if phz is None:
            thr, fp, fa = self.thresh, self.fprob, self.falias
        else:
            thr, fp, fa = (self.thresh[phz], self.fprob[phz],
                           self.falias[phz])
        if self.gain is not None:
            thr = thr * self.gain[i % len(self.gain)]
        want = u_want < thr
        j = torch.minimum((u1 * self.dgf).to(torch.int64), self.dg - 1)
        f0 = self.sptr + j.clamp(min=0)
        f0c = f0.clamp(max=self.F - 1)      # sources without flows
        fid = torch.where(u2 < fp[f0c], f0, fa[f0c])
        iq, ok0, dsts, fidc = self._first_queue(ph, fid)
        ic = iq // n_vc
        i_pop = (w_pop[ic] & (win_q[ic] == iq)).long()
        i_push = (firstq[iq] < C).long()
        size_iq = size[iq]
        inj = want & (size_iq - i_pop + i_push < slots) & (self.dg > 0)
        if ok0 is not None:
            inj = inj & ok0
        i_slot = (self.head[iq] + size_iq + i_push) % slots
        tag = (inj & measure).long() << _TAG_SHIFT
        if self.dense:
            inj_word = self.srcs | (dsts << _DST_SHIFT) | tag
        else:
            inj_word = fid | tag

        # ---- one scatter for pushes + injections, then sizes and heads ----
        rows = torch.cat([torch.where(w_push, tgt, NQ),
                          torch.where(inj, iq, NQ)])
        self.q[rows * slots + torch.cat([p_slot, i_slot])] = \
            torch.cat([push_word, inj_word])
        popq = torch.where(w_pop, win_q, NQ)
        self.size.index_add_(0, popq, self.m1)
        self.size.index_add_(0, rows, self.ones)
        self.head.index_add_(0, popq, self.ones[:C])
        self.head.remainder_(slots)

        # ---- counters and watchdog ----------------------------------------
        cons_lane = w_consume.view(R, n_ch).sum(dim=1)
        inj_lane = inj.view(R, n).sum(dim=1)
        tagged = (w_consume & (w_tag == 1)).view(R, n_ch).sum(dim=1)
        pop_lane = w_pop.view(R, n_ch).sum(dim=1)
        if measure:
            delta = torch.stack([want.view(R, n).sum(dim=1), inj_lane,
                                 tagged, cons_lane, cons_lane, inj_lane])
        else:
            zero = torch.zeros_like(cons_lane)
            delta = torch.stack([zero, zero, tagged, zero, cons_lane,
                                 inj_lane])
        self.stats += delta
        if self.T:
            self._count_tenants(w_word, w_consume, measure, fidc, inj)
        if self.adp:
            # per-queue persistent stall (drives escape diversion), and
            # escape diversions: pushes from a VC >= 1 onto VC 0
            popped = (w_pop[:, None]
                      & (win_q[:, None] == self.qrows_cv)).view(-1)
            self.stall = torch.where(nonempty & ~popped, self.stall + 1, 0)
            self.escaped += (w_push & (tgt % n_vc == 0)
                             & (win_v != 0)).view(R, n_ch).sum(dim=1)
        progress = (pop_lane > 0) | (inj_lane > 0)
        in_net = self.stats[5] - self.stats[4] > 0
        self.wstall = torch.where(in_net & ~progress, self.wstall + 1, 0)
        self.stalled_at = torch.where(
            (self.wstall >= self.watchdog) & (self.stalled_at < 0), i,
            self.stalled_at)
        return (self.wstall >= self.watchdog).all()

    def _word_tenant(self, w):
        """Tenant id of packet words (-1: none): by flow, or on the dense
        kernel by the (src, dst) pair the word carries."""
        if self.dense:
            return self.tmap[(w & _FIELD_MASK) * self.n
                             + ((w >> _DST_SHIFT) & _FIELD_MASK)]
        return self.tof[w & _FLOW_MASK]

    def _count_tenants(self, w_word, w_consume, measure, fidc, inj):
        T = self.T
        t_w = self._word_tenant(w_word)
        ok_w = (w_consume & (t_w >= 0)).long()
        rowc = self.lane_c_t + t_w.clamp(0, T - 1)
        self.cons_t.index_add_(0, rowc, ok_w)
        if measure:
            self.consm_t.index_add_(0, rowc, ok_w)
        t_i = self.tof[fidc]
        self.inj_t.index_add_(0, self.lane_n_t + t_i.clamp(0, T - 1),
                              (inj & (t_i >= 0)).long())

    def tenants_in_flight(self) -> torch.Tensor:
        """Per-(lane, tenant) words still queued at the end: slot j of
        queue r is live iff (j - head) % slots < size."""
        NQ, slots, T = self.NQ, self.slots, self.T
        dev = self.q.device
        occ = ((torch.arange(slots, device=dev)[None, :]
                - self.head[:NQ, None]) % slots) < self.size[:NQ, None]
        tw = self._word_tenant(self.q[:NQ * slots].view(NQ, slots))
        lane = torch.arange(NQ, device=dev) // (self.n_ch * self.n_vc)
        rows = lane[:, None] * T + tw.clamp(0, T - 1)
        return torch.zeros(self.R * T, dtype=torch.int64, device=dev)\
            .index_add_(0, rows.view(-1), (occ & (tw >= 0)).long().view(-1))

    def run(self, chain: torch.Tensor, cycles: int) -> int:
        """Run up to ``cycles`` cycles (``chain[c]`` is cycle c's key);
        stop after the first cycle that leaves every lane stalled.
        Returns the number of cycles run."""
        i = 0
        while i < cycles:
            b = min(_BLOCK, cycles - i)
            draws = prng.uniform_block(chain[i:i + b], self.N)
            saved = self.save()
            flags = torch.stack([self.cycle(i + k, *draws[k])
                                 for k in range(b)])
            if bool(flags.any()):                # one sync per block
                stop = int(flags.to(torch.int8).argmax())
                self.restore(saved)
                for k in range(stop + 1):
                    self.cycle(i + k, *draws[k])
                return i + stop + 1
            i += b
        return cycles


def _compiled_flows(traffic, tables: SimTables) -> CompiledFlowTraffic:
    """Compile any accepted traffic input onto the table's flow slots."""
    if isinstance(traffic, CompiledFlowTraffic):
        return traffic
    t = tables.csr()
    ct = compile_flow_traffic(traffic, t.src_indptr, t.dst)
    if ct.prob.shape[-1] != t.n_flows:
        raise ValueError("flow traffic does not match the path table")
    return ct


def sweep(tables: SimTables, rates: Sequence[float],
          traffic: Optional[Union[TrafficPattern, CompiledTraffic,
                                  CompiledFlowTraffic,
                                  PhasedTraffic]] = None,
          cycles: int = 6000, warmup: int = 2000, slots: int = 128,
          seed: int = 0, flits: int = 4, kernel: str = "csr",
          stats: Optional[dict] = None,
          adaptive: Optional[AdaptiveSpec] = None,
          fault: Optional[Tuple[int, Sequence[int]]] = None,
          patience: int = 64, watchdog: int = 512,
          device=None) -> List[Dict]:
    """Simulate every rate in one lane-flattened run; one dict per rate,
    equal to ``repro.core.netsim.sweep``'s for the same arguments.

    ``device`` (``None`` = CUDA, which raises when no GPU is present)
    holds the simulator state. ``kernel="dense"`` routes from the dense
    ``(n, n, MAXHOP)`` table with (src, dst) packet words -- the oracle
    whose counters equal the CSR kernel's. ``adaptive`` (an
    :func:`adaptive_spec`) switches to minimal adaptive routing with the
    VC 0 escape lane (``n_vc >= 2``, tables allocated with
    ``reserve_escape=True``); ``fault=(t, dead_channels)`` kills those
    channels at cycle ``t``; ``patience`` is the stalled cycles before an
    adaptive head diverts to the escape VC; ``watchdog`` the
    zero-progress window after which a lane is stalled. Bursty, phased
    (:class:`PhasedTraffic`) and multi-tenant patterns are taken as the
    reference takes them; a tenant map adds a ``"tenants"`` entry to
    every rate dict.

    ``stats``, when given, records the kernel, ``cycles_run`` (<
    ``cycles`` when every lane wedged and the run stopped early), the
    bytes of state and tables staged on the device under
    ``"array_bytes"``, and running totals ``sim_cycles`` and
    ``lane_cycles`` (cycles times rate lanes) over every sweep that
    shared the dict.
    """
    device = resolve_device(device)
    if MAXHOP > _HOP_MASK:
        raise ValueError(f"packed packet words support MAXHOP <= "
                         f"{_HOP_MASK}")
    if patience < 1:
        raise ValueError("patience must be >= 1")
    if watchdog < 1:
        raise ValueError("watchdog must be >= 1")
    if adaptive is not None and tables.n_vc < 2:
        raise ValueError("adaptive routing reserves VC 0 as the escape "
                         "lane and needs n_vc >= 2")
    n, n_ch, n_vc = tables.n, tables.n_ch, tables.n_vc
    sim_fault = None
    aux_bytes = 0
    if fault is not None:
        t_fault, dead_in = fault
        t_fault = int(t_fault)
        if not 0 <= t_fault <= cycles:
            raise ValueError(f"fault cycle {t_fault} outside "
                             f"[0, {cycles}]")
        dead = _dead_channel_array(dead_in)
        if dead is not None and ((dead < 0).any() or (dead >= n_ch).any()):
            bad = dead[(dead < 0) | (dead >= n_ch)]
            raise ValueError(f"unknown channel ids {bad.tolist()} "
                             f"(topology has {n_ch} channels)")
        alive = np.ones((2, n_ch), bool)
        if dead is not None:
            alive[1, dead] = False
        sim_fault = (t_fault, alive)
        aux_bytes += alive.nbytes
    if adaptive is not None:
        if adaptive.esc.shape != (2, n, n):
            raise ValueError("adaptive spec built for a different "
                             "topology")
        aux_bytes += 8 * (adaptive.esc.size + adaptive.minmask.size
                          + adaptive.outch.size)
    ct = _compiled_flows(traffic, tables)
    rates = np.asarray(list(rates), np.float32)
    R = len(rates)
    NQ = R * n_ch * n_vc
    gain = None
    if ct.burst is not None:
        on_cycles, g_on, g_off, phase = ct.burst.realize(n)
        period = int(ct.burst.period)
        phs = np.tile(np.asarray(phase, np.int64), R)
        on = (np.arange(period)[:, None] + phs[None, :]) % period \
            < on_cycles
        gain = np.where(on, np.float32(g_on), np.float32(g_off)) \
            .astype(np.float32)
        aux_bytes += gain.nbytes
    phase_of = None
    if ct.phases > 0:
        phase_of = np.asarray(ct.phase_of, np.int64)
    tenants = ct.tenants
    T = tenants.n_tenants if tenants is not None else 0
    F = int(ct.prob.shape[-1])
    state_bytes = (NQ + 1) * slots * 8 + (NQ + 1) * 16 \
        + R * n_ch * 16
    if adaptive is not None:
        state_bytes += NQ * 8     # per-queue stall counters
    traffic_bytes = (ct.src_indptr.nbytes + ct.deg.nbytes + ct.prob.nbytes
                     + ct.alias.nbytes + ct.src_rate.nbytes)
    if F == 0:
        if stats is not None:
            stats["kernel"] = kernel
            stats["cycles_run"] = cycles
            stats["array_bytes"] = max(stats.get("array_bytes", 0),
                                       state_bytes + traffic_bytes)
        return [{"rate": float(r), "offered": 0.0, "accepted": 0.0,
                 "delivered": 0.0, "delivered_tagged": 0.0,
                 "consumed_total": 0, "injected_total": 0, "in_flight": 0,
                 "escaped": 0, "stalled_at": -1}
                for r in rates]
    t = tables.csr()
    if kernel == "csr":
        if t.n_flows > _FLOW_MASK:
            raise ValueError(f"packed packet words support F <= "
                             f"{_FLOW_MASK} flows")
        lenm1 = np.diff(t.hop_indptr).astype(np.int64) - 1
        if len(lenm1) and (lenm1 < 0).any():
            raise ValueError(
                "path table contains zero-length (lost) flow slots -- "
                "the kernel samples traffic over flow slots and cannot "
                "inject a packet with no route; compact a degraded "
                "serving table first (CSRPathTable.compact() drops "
                "lost pairs and remaps flow ids)")
        route = dict(pvf=t.chan.astype(np.int64) * n_vc
                     + t.vc.astype(np.int64),
                     hptr=t.hop_indptr[:-1].astype(np.int64), lenm1=lenm1)
        if adaptive is not None:
            route["dstN"] = np.asarray(t.dst, np.int64)  # flow -> dst
    elif kernel == "dense":
        if n > _FIELD_MASK:
            raise ValueError(f"the dense kernel's packed packet words "
                             f"support n <= {_FIELD_MASK}")
        # composite per-hop (channel * n_vc + vc) table, flat
        pv = np.where(tables.path < 0, -1,
                      tables.path.astype(np.int64) * n_vc
                      + tables.vcs.astype(np.int64))
        route = dict(pv=pv.reshape(-1), fdst=np.asarray(t.dst, np.int64))
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    if T:
        tmap = np.asarray(tenants.pair_tenant, np.int64)
        fsrc = np.repeat(np.arange(n), np.diff(t.src_indptr).astype(np.int64))
        tof = tmap[fsrc, np.asarray(t.dst, np.int64)]
        aux_bytes += tmap.nbytes + tof.nbytes
    # float32 products, as the reference's (rates[:, None] * src_rate),
    # one row per demand phase when phased
    src_rate = np.asarray(ct.src_rate, np.float32)
    thresh = (rates[:, None] * src_rate[..., None, :]).reshape(
        src_rate.shape[:-1] + (-1,))
    if stats is not None:
        stats["kernel"] = kernel
        stats["array_bytes"] = max(
            stats.get("array_bytes", 0),
            state_bytes + traffic_bytes + aux_bytes
            + sum(v.nbytes for v in route.values()))
    sim = _Sim(route, np.asarray(ct.src_indptr[:-1], np.int64),
               np.asarray(ct.deg, np.int64),
               np.asarray(ct.prob, np.float32),
               np.asarray(ct.alias, np.int64), thresh, R=R, n=n,
               n_ch=n_ch, n_vc=n_vc, slots=slots, warmup=warmup,
               flits=flits, watchdog=watchdog, device=device,
               dense=kernel == "dense", ch_dst=tables.ch_dst,
               adaptive=adaptive, patience=patience, fault=sim_fault,
               gain=gain, phase_of=phase_of,
               tenants=(T, tof, tmap) if T else None)
    chain = prng.key_chain(prng.seed_key(seed), cycles).to(device)
    cycles_run = sim.run(chain, cycles)
    off, acc, tagd, consm, cons, injd = sim.stats.cpu().numpy()
    infl = sim.size[:sim.NQ].view(R, -1).sum(dim=1).cpu().numpy()
    stalled = sim.stalled_at.cpu().numpy()
    escd = sim.escaped.cpu().numpy() if adaptive is not None \
        else np.zeros(R, np.int64)
    if T:
        inj_t, cons_t, consm_t = (x.cpu().numpy() for x in
                                  (sim.inj_t, sim.cons_t, sim.consm_t))
        infl_t = sim.tenants_in_flight().cpu().numpy()
    if stats is not None:
        stats["cycles_run"] = cycles_run
        # running totals over every sweep that shared this dict
        stats["sim_cycles"] = stats.get("sim_cycles", 0) + cycles_run
        stats["lane_cycles"] = stats.get("lane_cycles", 0) + R * cycles_run
    meas = cycles - warmup
    trace = []
    for i, rate in enumerate(rates):
        trace.append({
            "rate": float(rate),
            "offered": float(off[i]) / meas / n,
            "accepted": float(acc[i]) / meas / n,
            "delivered": float(consm[i]) / meas / n,
            "delivered_tagged": float(tagd[i]) / meas / n,
            "consumed_total": int(cons[i]),
            "injected_total": int(injd[i]),
            "in_flight": int(infl[i]),
            "escaped": int(escd[i]),
            "stalled_at": int(stalled[i]),
        })
        if T:
            # per tenant: injected == consumed + in_flight exactly
            tens = {}
            for t_id, name in enumerate(tenants.names):
                k = i * T + t_id
                tens[name] = {
                    "injected": int(inj_t[k]),
                    "consumed": int(cons_t[k]),
                    "in_flight": int(infl_t[k]),
                    "delivered": float(consm_t[k]) / meas
                    / max(int(tenants.n_nodes[t_id]), 1),
                }
            trace[-1]["tenants"] = tens
    return trace


def run(tables: SimTables, rate: float,
        traffic: Optional[Union[TrafficPattern, CompiledTraffic,
                                CompiledFlowTraffic]] = None,
        cycles: int = 6000, warmup: int = 2000, slots: int = 128,
        seed: int = 0, flits: int = 4, kernel: str = "csr",
        stats: Optional[dict] = None, adaptive=None, fault=None,
        patience: int = 64, watchdog: int = 512, device=None) -> Dict:
    """Single-rate convenience wrapper over :func:`sweep`."""
    return sweep(tables, [rate], traffic, cycles=cycles, warmup=warmup,
                 slots=slots, seed=seed, flits=flits, kernel=kernel,
                 stats=stats, adaptive=adaptive, fault=fault,
                 patience=patience, watchdog=watchdog, device=device)[0]


def saturation_point(tables: SimTables, step: float = 0.01,
                     max_rate: float = 1.0, deficit: float = 0.05,
                     cycles: int = 6000, warmup: int = 2000,
                     slots: int = 128, flits: int = 4,
                     traffic: Optional[Union[TrafficPattern,
                                             CompiledTraffic,
                                             CompiledFlowTraffic]] = None,
                     seed: int = 0, kernel: str = "csr",
                     stats: Optional[dict] = None, adaptive=None,
                     patience: int = 64, watchdog: int = 512,
                     device=None) -> Tuple[float, List[Dict]]:
    """Saturation = last rate whose delivered throughput covers
    (1 - deficit) of offered, before the first shortfall.

    The reference's two batched stages: a coarse sub-grid at half the
    cycle budget brackets the saturation rate, then the grid rates inside
    the bracketing cell run at full fidelity (sliding down a cell while
    the window's first rate already fails). Only full-fidelity rates
    enter the returned trace.
    """
    device = resolve_device(device)
    ct = _compiled_flows(traffic, tables)
    rates = np.arange(step, max_rate + 1e-9, step)
    stride = max(1, int(round(np.sqrt(len(rates)))))
    coarse_idx = list(range(stride - 1, len(rates), stride))
    if coarse_idx[-1] != len(rates) - 1:
        coarse_idx.append(len(rates) - 1)
    kw = dict(slots=slots, seed=seed, flits=flits, kernel=kernel,
              stats=stats, adaptive=adaptive, patience=patience,
              watchdog=watchdog, device=device)
    coarse = sweep(tables, rates[coarse_idx], ct,
                   cycles=max(cycles // 2, warmup // 2 + 1),
                   warmup=warmup // 2, **kw)

    def ok(r):
        return r["delivered"] >= (1 - deficit) * r["offered"]

    first_bad = next((i for i, r in enumerate(coarse) if not ok(r)),
                     None)
    if first_bad is None:
        lo, hi = max(len(rates) - stride, 0), len(rates)
    else:
        lo = coarse_idx[first_bad - 1] + 1 if first_bad >= 1 else 0
        hi = coarse_idx[first_bad] + 1
    trace: List[Dict] = []
    while True:
        fine = sweep(tables, rates[lo:hi], ct, cycles=cycles,
                     warmup=warmup, **kw)
        trace = fine + trace
        if lo == 0 or (fine and ok(fine[0])):
            break
        hi = lo
        lo = max(lo - stride, 0)
    sat = 0.0
    for r in trace:
        if ok(r):
            sat = r["delivered"]
        else:
            break
    return sat, trace


# ---------------------------------------------------------------------------
# DOR baseline on prismatic tori (XYZ order, dateline VC switching)
# ---------------------------------------------------------------------------


def dor_paths(topo: Topology) -> PathTable:
    """Dimension-ordered minimal routing on a torus with dateline VC rule:
    start on VC0, switch to VC1 after crossing a wrap link in any dim.
    Vectorised over all (src, dst) pairs (numpy, host)."""
    ch = Channels.from_topology(topo)
    pod = topo.pod
    n = topo.n
    X, Y, Z = pod.dims
    chan_of = np.full((n, n), -1, np.int64)
    chan_of[ch.src, ch.dst] = np.arange(ch.n)

    coords = pod.all_coords().astype(np.int64)
    cur = np.broadcast_to(coords[:, None, :], (n, n, 3)).copy()
    tgt = np.broadcast_to(coords[None, :, :], (n, n, 3))

    table = PathTable.empty(n, ch.n, 2)
    hops = table.hops
    vc = np.zeros((n, n), np.int8)
    for axis in range(3):
        dim = pod.dims[axis]
        delta = (tgt[..., axis] - cur[..., axis]) % dim
        step = np.where(2 * delta <= dim, 1, -1)
        count = np.where(step == 1, delta, dim - delta)
        for k in range(dim // 2):
            act = count > k
            if not act.any():
                break
            c_ax = cur[..., axis]
            nxt_ax = (c_ax + step) % dim
            nxt = cur.copy()
            nxt[..., axis] = nxt_ax
            u = cur[..., 0] + X * (cur[..., 1] + Y * cur[..., 2])
            v = nxt[..., 0] + X * (nxt[..., 1] + Y * nxt[..., 2])
            si, di = np.nonzero(act)
            cidx = chan_of[u[si, di], v[si, di]]
            if (cidx < 0).any():
                raise KeyError("DOR needs torus links along every axis")
            crossed = ((step == 1) & (nxt_ax == 0)) | \
                ((step == -1) & (c_ax == 0))
            vc = np.where(act & crossed, np.int8(1), vc)
            h = hops[si, di]
            table.path[si, di, h] = cidx.astype(np.int32)
            table.vcs[si, di, h] = vc[si, di]
            hops[si, di] = h + 1
            cur = np.where(act[..., None], nxt, cur)
    return table


def dor_tables(topo: Topology, n_vc: int = 2) -> SimTables:
    table = dor_paths(topo)
    table.n_vc = n_vc
    return build_tables(topo, table)


def at_tables(topo: Topology, at: ATResult, routed: RoutingResult,
              balance: Optional[bool] = True,
              stats: Optional[dict] = None,
              reserve_escape: bool = False) -> SimTables:
    """VC-allocate the routed paths (on a copy of ``routed.table``) and
    build simulator tables. ``balance=None`` keeps the VCs already in the
    table; ``reserve_escape=True`` keeps VC 0 free (needs re-allocation).
    """
    from repro_torch.core.vcalloc import allocate_vcs
    if reserve_escape and balance is None:
        raise ValueError("reserve_escape needs VC re-allocation "
                         "(balance=True or False)")
    table = routed.table.copy()
    if balance is not None:
        allocate_vcs(at, table, balance=balance, stats=stats,
                     reserve_escape=reserve_escape)
    table.n_vc = at.n_vc
    return build_tables(topo, table)
