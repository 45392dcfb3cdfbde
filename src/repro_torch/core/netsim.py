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

Ported here: the static tables (``dor_tables``, ``at_tables``), stationary
traffic patterns, ``sweep``/``run``/``saturation_point``. Adaptive
routing, mid-sweep faults, bursty, phased and multi-tenant traffic and
the dense oracle kernel raise ``NotImplementedError`` (not yet ported).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.pathtable import MAXHOP, CSRPathTable, PathTable
from repro_torch.core.routing import ATResult, Channels, RoutingResult
from repro_torch.core.topology import Topology
from repro_torch.core.traffic import (CompiledFlowTraffic, CompiledTraffic,
                                      TrafficPattern, compile_flow_traffic)
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


# Packet word: flow[0:24] | hop[24:30] | tag[30] (the reference's CSR word)
_HOP_SHIFT = 24
_TAG_SHIFT = 30
_HOP_MASK = (1 << 6) - 1
_FLOW_MASK = (1 << 24) - 1

_BLOCK = 256          # cycles per block of draws / stop check


class _Sim:
    """One lane-flattened sweep: R simulations (one per rate) on the CSR
    hop arrays. Lane ``l``'s queue (c, v) is flat row
    ``l * n_ch * n_vc + c * n_vc + v``; row ``NQ`` is the padding row
    that takes every dropped write."""

    def __init__(self, pvf, hptr, lenm1, src_ptr, deg, fprob, falias,
                 thresh, *, R, n, n_ch, n_vc, slots, warmup, flits,
                 watchdog, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.R, self.n, self.n_ch, self.n_vc = R, n, n_ch, n_vc
        self.slots, self.warmup, self.flits = slots, warmup, flits
        self.watchdog = watchdog
        self.C = C = R * n_ch
        self.NQ = NQ = C * n_vc
        self.N = N = R * n
        self.pvf = torch.as_tensor(pvf, device=device)
        self.hptr = torch.as_tensor(hptr, device=device)
        self.lenm1 = torch.as_tensor(lenm1, device=device)
        self.fprob = torch.as_tensor(fprob, device=device)
        self.falias = torch.as_tensor(falias, device=device)
        self.thresh = torch.as_tensor(thresh, device=device)
        self.H = len(pvf)
        self.F = len(fprob)
        per_lane = n_ch * n_vc
        self.ar_c = torch.arange(C, **i64)
        self.ar_vc = torch.arange(n_vc, **i64)
        self.row_base = torch.arange(NQ, **i64) * slots
        self.lane_base = (torch.arange(NQ, **i64) // per_lane) * per_lane
        ar_n = torch.arange(N, **i64)
        srcs = ar_n % n
        self.lane_q = (ar_n // n) * per_lane
        self.dg = torch.as_tensor(deg, device=device)[srcs]
        self.dgf = self.dg.to(torch.float32)
        self.sptr = torch.as_tensor(src_ptr, device=device)[srcs]
        self.m1 = torch.full((C,), -1, **i64)
        self.ones = torch.ones(C + N, **i64)
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

    _STATE = ("q", "head", "size", "rr", "busy", "stats", "wstall",
              "stalled_at")

    def save(self):
        return {k: getattr(self, k).clone() for k in self._STATE}

    def restore(self, saved):
        for k, v in saved.items():
            setattr(self, k, v)

    def cycle(self, i: int, u_want, u1, u2) -> torch.Tensor:
        """One cycle (``netsim._sweep_csr``'s body, static path); returns
        the device flag "every lane is stalled" after it."""
        NQ, C, R, n, n_ch, n_vc = (self.NQ, self.C, self.R, self.n,
                                    self.n_ch, self.n_vc)
        slots = self.slots
        size = self.size[:NQ]

        # ---- head packet per (lane, channel, vc) --------------------------
        hw = self.q[self.row_base + self.head[:NQ]]
        hf = hw & _FLOW_MASK
        hh = (hw >> _HOP_SHIFT) & _HOP_MASK
        nonempty = size > 0
        consume_q = nonempty & (hh == self.lenm1[hf])
        nxt = self.pvf[torch.clamp(self.hptr[hf] + hh + 1, max=self.H - 1)]
        tq = torch.where(consume_q, -1, self.lane_base + nxt)
        fwd_ok = nonempty & ~consume_q & (size[tq.clamp(0, NQ - 1)] < slots)

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
        push_word = w_word + (1 << _HOP_SHIFT)        # hop += 1

        # ---- injection: alias-sampled routed flow per source --------------
        measure = i >= self.warmup
        want = u_want < self.thresh
        j = torch.minimum((u1 * self.dgf).to(torch.int64), self.dg - 1)
        f0 = self.sptr + j.clamp(min=0)
        f0c = f0.clamp(max=self.F - 1)      # sources without flows
        fid = torch.where(u2 < self.fprob[f0c], f0, self.falias[f0c])
        cv0 = self.pvf[self.hptr[fid.clamp(max=self.F - 1)]]
        iq = self.lane_q + cv0
        ic = iq // n_vc
        i_pop = (w_pop[ic] & (win_q[ic] == iq)).long()
        i_push = (firstq[iq] < C).long()
        size_iq = size[iq]
        inj = want & (size_iq - i_pop + i_push < slots) & (self.dg > 0)
        i_slot = (self.head[iq] + size_iq + i_push) % slots
        inj_word = fid | ((inj & measure).long() << _TAG_SHIFT)

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
        progress = (pop_lane > 0) | (inj_lane > 0)
        in_net = self.stats[5] - self.stats[4] > 0
        self.wstall = torch.where(in_net & ~progress, self.wstall + 1, 0)
        self.stalled_at = torch.where(
            (self.wstall >= self.watchdog) & (self.stalled_at < 0), i,
            self.stalled_at)
        return (self.wstall >= self.watchdog).all()

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


def _not_yet(what: str):
    return NotImplementedError(f"{what} is not yet ported to repro_torch "
                               "(the reference repro.core.netsim has it)")


def sweep(tables: SimTables, rates: Sequence[float],
          traffic: Optional[Union[TrafficPattern, CompiledTraffic,
                                  CompiledFlowTraffic]] = None,
          cycles: int = 6000, warmup: int = 2000, slots: int = 128,
          seed: int = 0, flits: int = 4, kernel: str = "csr",
          stats: Optional[dict] = None, adaptive=None, fault=None,
          patience: int = 64, watchdog: int = 512,
          device=None) -> List[Dict]:
    """Simulate every rate in one lane-flattened run; one dict per rate,
    equal to ``repro.core.netsim.sweep``'s for the same arguments.

    ``device`` (``None`` = CUDA, which raises when no GPU is present)
    holds the simulator state. ``stats``, when given, records the kernel,
    ``cycles_run`` (< ``cycles`` when every lane wedged and the run
    stopped early), the bytes of state and tables staged on the device
    under ``"array_bytes"``, and running totals ``sim_cycles`` and
    ``lane_cycles`` (cycles times rate lanes) over every sweep that
    shared the dict.
    """
    device = resolve_device(device)
    if kernel == "dense":
        raise _not_yet("the dense oracle kernel")
    if kernel != "csr":
        raise ValueError(f"unknown kernel {kernel!r}")
    if adaptive is not None:
        raise _not_yet("adaptive routing")
    if fault is not None:
        raise _not_yet("mid-sweep fault injection")
    if MAXHOP > _HOP_MASK:
        raise ValueError(f"packed packet words support MAXHOP <= "
                         f"{_HOP_MASK}")
    if patience < 1:
        raise ValueError("patience must be >= 1")
    if watchdog < 1:
        raise ValueError("watchdog must be >= 1")
    ct = _compiled_flows(traffic, tables)
    if ct.burst is not None:
        raise _not_yet("bursty traffic")
    if ct.phases > 0:
        raise _not_yet("phased traffic")
    if ct.tenants is not None:
        raise _not_yet("multi-tenant traffic")
    rates = np.asarray(list(rates), np.float32)
    R = len(rates)
    NQ = R * tables.n_ch * tables.n_vc
    F = int(ct.prob.shape[-1])
    state_bytes = (NQ + 1) * slots * 8 + (NQ + 1) * 16 \
        + R * tables.n_ch * 16
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
    if t.n_flows > _FLOW_MASK:
        raise ValueError(f"packed packet words support F <= {_FLOW_MASK} "
                         "flows")
    pvf = t.chan.astype(np.int64) * tables.n_vc + t.vc.astype(np.int64)
    hptr = t.hop_indptr[:-1].astype(np.int64)
    lenm1 = np.diff(t.hop_indptr).astype(np.int64) - 1
    if len(lenm1) and (lenm1 < 0).any():
        raise ValueError(
            "path table contains zero-length (lost) flow slots -- the "
            "kernel samples traffic over flow slots and cannot inject a "
            "packet with no route; compact a degraded serving table first "
            "(CSRPathTable.compact() drops lost pairs and remaps flow ids)")
    # float32 product, as the reference's (rates[:, None] * src_rate)
    thresh = (rates[:, None] * np.asarray(ct.src_rate, np.float32)[None, :]
              ).reshape(-1)
    if stats is not None:
        stats["kernel"] = kernel
        stats["array_bytes"] = max(
            stats.get("array_bytes", 0),
            state_bytes + traffic_bytes + pvf.nbytes + hptr.nbytes
            + lenm1.nbytes)
    sim = _Sim(pvf, hptr, lenm1, np.asarray(ct.src_indptr[:-1], np.int64),
               np.asarray(ct.deg, np.int64),
               np.asarray(ct.prob, np.float32),
               np.asarray(ct.alias, np.int64), thresh, R=R, n=tables.n,
               n_ch=tables.n_ch, n_vc=tables.n_vc, slots=slots,
               warmup=warmup, flits=flits, watchdog=watchdog, device=device)
    chain = prng.key_chain(prng.seed_key(seed), cycles).to(device)
    cycles_run = sim.run(chain, cycles)
    off, acc, tagd, consm, cons, injd = sim.stats.cpu().numpy()
    infl = sim.size[:sim.NQ].view(R, -1).sum(dim=1).cpu().numpy()
    stalled = sim.stalled_at.cpu().numpy()
    if stats is not None:
        stats["cycles_run"] = cycles_run
        # running totals over every sweep that shared this dict
        stats["sim_cycles"] = stats.get("sim_cycles", 0) + cycles_run
        stats["lane_cycles"] = stats.get("lane_cycles", 0) + R * cycles_run
    meas = cycles - warmup
    return [{
        "rate": float(rate),
        "offered": float(off[i]) / meas / tables.n,
        "accepted": float(acc[i]) / meas / tables.n,
        "delivered": float(consm[i]) / meas / tables.n,
        "delivered_tagged": float(tagd[i]) / meas / tables.n,
        "consumed_total": int(cons[i]),
        "injected_total": int(injd[i]),
        "in_flight": int(infl[i]),
        "escaped": 0,
        "stalled_at": int(stalled[i]),
    } for i, rate in enumerate(rates)]


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
