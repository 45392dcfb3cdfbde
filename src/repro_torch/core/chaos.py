"""Chaos campaign engine: multi-fault schedules, degraded-mode serving
and channel restoration over a live fabric.

Port of ``repro.core.chaos``: host code, unchanged except that the
throughput probes take ``device`` for the simulator.

:func:`~repro_torch.core.repair.repair_fault` handles a single fault;
:func:`~repro_torch.core.fault.fault_event` injects one mid-sweep OCS
loss. Production resilience (MRC/SRv6; ACOS's many cheap fault-prone
optical switches -- PAPERS.md) is a *timeline*: faults arrive, overlap,
and heal. This module generates seeded randomized fault schedules and
drives a :class:`~repro_torch.core.repair.ServingState` through them:

- **Event kinds.** ``ocs`` (one optical switch dies, killing every
  link routed through it), ``links`` (a correlated regional group:
  every channel incident to a node neighbourhood -- the shared-rack /
  shared-power failure domain; the fully-isolating variant forces a
  genuine disconnection served in degraded mode), storms (multiple OCS
  losses with overlapping arrival times, coalesced by the campaign
  runner into ONE repair pool), and ``restore`` events that revive
  previously-failed channels
  (:func:`~repro_torch.core.repair.restore_channels`).
- **Machine-checked invariants** after every event -- chaos is only
  useful when every step is checkable: reachability accounting (the
  lost set is exactly the set of truly disconnected pairs), deadlock
  freedom of the whole served table, loads / VC-count consistency
  against the table, untouched-flow bit-identity versus the pre-event
  table, and no dead channel under any served path.
- **Metrics** per event: MTTR (repair wall-clock), flows re-routed,
  lost pairs, served-pair availability, post-event ``l_max``, and
  optional netsim throughput probes (the degraded table compacted
  through the CSR kernel, watchdog outputs included).

Every random draw -- schedule sampling and the repair engines'
tie-breaking -- comes from explicit seeded ``np.random.Generator``
state, so a campaign replays bit-identically from its seed
(:func:`CampaignResult.fingerprint` condenses the outcome for replay
equality checks).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.repair import (RepairResult, ServingState,
                                     repair_fault, restore_channels)
from repro_torch.core.routing import node_distances
from repro_torch.core.vcalloc import verify_deadlock_free

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChaosEvent:
    """One arrival on the campaign timeline. ``kind`` is ``"ocs"``,
    ``"links"`` or ``"restore"``; ``channels`` is the sorted channel-id
    set the event kills / revives; ``colors`` names the OCS colors
    involved (empty for link groups)."""
    t: float
    kind: str
    channels: np.ndarray
    colors: Tuple[int, ...] = ()


@dataclasses.dataclass
class ChaosSchedule:
    """A seeded fault/heal timeline. ``events`` are in arrival order;
    regenerating with the same AT and parameters replays the identical
    schedule (every sample comes from one ``default_rng(seed)``)."""
    seed: int
    events: List[ChaosEvent]

    @property
    def n_events(self) -> int:
        return len(self.events)

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


def generate_schedule(at, n_arrivals: int = 20, seed: int = 0,
                      p_storm: float = 0.2, p_links: float = 0.25,
                      p_restore: float = 0.25,
                      storm_size: Tuple[int, int] = (2, 4),
                      storm_span: float = 0.5, mean_gap: float = 10.0,
                      p_disconnect: float = 0.5,
                      ensure_coverage: bool = True,
                      final_heal: bool = True) -> ChaosSchedule:
    """Sample a randomized fault/heal timeline against an AT's channel
    space. ``n_arrivals`` counts sampling steps; storms emit several
    events per step, so ``len(schedule.events)`` can exceed it.

    Arrival gaps are exponential with mean ``mean_gap``; a storm packs
    its OCS losses within ``storm_span`` (below the campaign runner's
    default coalescing window, so they repair as one pool). ``links``
    events kill the channels incident to a random node -- with
    probability ``p_disconnect`` *all* of them, isolating the node so
    the fabric must serve degraded. Restores revive a previously-failed
    OCS in full or a random slice of the currently-dead set.

    ``ensure_coverage`` pins one storm and one isolating link-group
    onto random slots so every campaign exercises the coalescing and
    degraded-mode paths; ``final_heal`` appends a restore of whatever
    is still dead, closing the fault->heal round trip. The generation
    itself tracks the evolving dead set, so every event is well-formed
    (restores only touch dead channels, faults only live ones).
    """
    rng = np.random.default_rng(seed)
    ch = at.channels
    colors = np.unique(ch.color[ch.color >= 0]).astype(np.int64)
    live_colors = colors.tolist()
    dead_colors: List[int] = []
    dead = np.zeros(0, np.int64)
    events: List[ChaosEvent] = []
    t = 0.0

    forced: Dict[int, str] = {}
    if ensure_coverage and n_arrivals >= 6:
        pos = rng.choice(np.arange(1, n_arrivals), size=2, replace=False)
        forced = {int(pos[0]): "storm", int(pos[1]): "isolate"}

    def color_channels(c: int) -> np.ndarray:
        return np.sort(np.nonzero(ch.color == c)[0].astype(np.int64))

    for i in range(n_arrivals):
        t += float(rng.exponential(mean_gap))
        r = float(rng.random())
        kind = forced.get(i)
        if kind is None:
            if r < p_restore and len(dead):
                kind = "restore"
            elif r < p_restore + p_storm and len(live_colors) >= 2:
                kind = "storm"
            elif r < p_restore + p_storm + p_links:
                kind = "links"
            elif live_colors:
                kind = "ocs"
            else:
                kind = "restore" if len(dead) else "links"

        if kind == "restore":
            if not len(dead):
                continue
            if dead_colors and rng.random() < 0.7:
                c = dead_colors.pop(int(rng.integers(len(dead_colors))))
                live_colors.append(c)
                chans = np.intersect1d(color_channels(c), dead)
                if not len(chans):
                    continue
                ev = ChaosEvent(t, "restore", chans, (int(c),))
            else:
                k = int(rng.integers(1, len(dead) + 1))
                chans = np.sort(rng.choice(dead, size=k, replace=False))
                ev = ChaosEvent(t, "restore", chans)
                # a random slice may fully revive some OCS's channels
                for c in list(dead_colors):
                    cc = color_channels(c)
                    if not len(np.setdiff1d(cc, np.setdiff1d(dead, chans))):
                        dead_colors.remove(c)
                        live_colors.append(c)
            dead = np.setdiff1d(dead, ev.channels)
            events.append(ev)
        elif kind == "storm" and len(live_colors) >= 2:
            k = min(int(rng.integers(storm_size[0], storm_size[1] + 1)),
                    len(live_colors))
            picks = sorted(rng.choice(len(live_colors), size=k,
                                      replace=False).tolist(),
                           reverse=True)
            offs = np.sort(rng.random(k)) * storm_span
            for j, pi in enumerate(picks):
                c = live_colors.pop(pi)
                dead_colors.append(c)
                chans = color_channels(c)
                events.append(ChaosEvent(t + float(offs[j]), "ocs",
                                         chans, (int(c),)))
                dead = np.union1d(dead, chans)
        elif kind in ("links", "isolate"):
            node = int(rng.integers(ch.n_nodes))
            inc = np.sort(np.nonzero((ch.src == node)
                                     | (ch.dst == node))[0]).astype(np.int64)
            if kind == "isolate" or rng.random() < p_disconnect:
                chans = inc                      # full isolation
            else:
                chans = inc[ch.color[inc] < 0]   # electrical links only
            if not len(np.setdiff1d(chans, dead)):
                continue
            events.append(ChaosEvent(t, "links", chans))
            dead = np.union1d(dead, chans)
        elif kind == "ocs" and live_colors:
            c = live_colors.pop(int(rng.integers(len(live_colors))))
            dead_colors.append(c)
            chans = color_channels(c)
            events.append(ChaosEvent(t, "ocs", chans, (int(c),)))
            dead = np.union1d(dead, chans)

    if final_heal and len(dead):
        t += float(rng.exponential(mean_gap))
        events.append(ChaosEvent(t, "restore", dead.copy()))
    events.sort(key=lambda e: e.t)
    return ChaosSchedule(seed, events)


# ---------------------------------------------------------------------------
# Invariant suite
# ---------------------------------------------------------------------------


def _hop_ranges(hop_indptr: np.ndarray, flows: np.ndarray) -> np.ndarray:
    lens = (hop_indptr[flows + 1] - hop_indptr[flows]).astype(np.int64)
    return np.repeat(hop_indptr[flows] - (np.cumsum(lens) - lens),
                     lens) + np.arange(int(lens.sum()), dtype=np.int64)


def check_invariants(prev: ServingState, rr: RepairResult,
                     untouched: bool = True) -> Dict[str, bool]:
    """The full post-event invariant suite, each check independent so a
    failure pinpoints the broken layer:

    - ``loads_match`` / ``vc_counts_match``: the state's incremental
      load and per-VC hop accounting equals a from-scratch reduction
      over the table.
    - ``no_dead_channel``: no served path crosses a dead channel.
    - ``deadlock_free``: every consecutive (channel, vc) hop of every
      served flow is an allowed turn (whole table, not just the pool).
    - ``lost_is_zero_length``: the lost-flow bookkeeping is exactly the
      set of zero-length table slots.
    - ``lost_truly_unreachable``: reachability accounting -- every lost
      pair is genuinely disconnected on the current AT with the current
      dead set (a reachable pair parked in ``lost`` is a repair bug;
      served pairs carry their own constructive proof, a verified
      path).
    - ``untouched_bit_identical``: flows outside the event's re-route
      pool kept byte-for-byte identical hops and VCs.
    """
    st = rr.state
    table = st.table
    out: Dict[str, bool] = {}
    out["loads_match"] = bool(
        (st.loads[:-1] == table.loads().astype(np.int64)).all())
    out["vc_counts_match"] = bool(
        (st.vc_counts == table.vc_hop_counts()).all())
    dead_mask = np.zeros(st.at.channels.n, bool)
    dead_mask[st.dead] = True
    out["no_dead_channel"] = not bool(dead_mask[table.chan].any())
    out["deadlock_free"] = bool(verify_deadlock_free(st.at, table))
    zero = np.nonzero(table.flow_len == 0)[0]
    out["lost_is_zero_length"] = bool(
        np.array_equal(np.sort(np.asarray(st.lost, np.int64)), zero))
    if len(st.lost):
        srcs = np.unique(table.flow_src[st.lost].astype(np.int64))
        best = node_distances(st.at, srcs, dead_channels=st.dead)
        pos = np.searchsorted(srcs, table.flow_src[st.lost])
        out["lost_truly_unreachable"] = bool(
            (best[pos, table.dst[st.lost]] < 0).all())
    else:
        out["lost_truly_unreachable"] = True
    if untouched and rr.pool_flows is not None \
            and prev.table.n_flows == table.n_flows and not rr.fallback:
        un = np.setdiff1d(np.arange(table.n_flows, dtype=np.int64),
                          rr.pool_flows)
        p0, p1 = prev.table, table
        l0 = (p0.hop_indptr[un + 1] - p0.hop_indptr[un])
        l1 = (p1.hop_indptr[un + 1] - p1.hop_indptr[un])
        same = np.array_equal(l0, l1)
        if same and len(un):
            i0 = _hop_ranges(p0.hop_indptr, un)
            i1 = _hop_ranges(p1.hop_indptr, un)
            same = (np.array_equal(p0.chan[i0], p1.chan[i1])
                    and np.array_equal(p0.vc[i0], p1.vc[i1]))
        out["untouched_bit_identical"] = bool(same)
    return out


# ---------------------------------------------------------------------------
# Campaign runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EventRecord:
    """Per-event campaign telemetry; everything scalar so records
    JSON-serialise straight into the benchmark trackers."""
    t: float
    kind: str                  # "ocs" | "links" | "storm" | "restore"
    n_channels: int
    coalesced: int             # arrivals merged into this repair pool
    mttr_s: float              # repair/restore wall-clock
    flows_rerouted: int
    lost_pairs: int
    served_fraction: float
    l_max: float
    fallback: bool
    readmitted: int
    invariants: Dict[str, bool]
    probe: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return all(self.invariants.values())


@dataclasses.dataclass
class CampaignResult:
    schedule: ChaosSchedule
    records: List[EventRecord]
    state: ServingState        # the post-campaign serving state
    baseline_l_max: float
    baseline_probe: Optional[dict] = None

    @property
    def ok(self) -> bool:
        """Every invariant of every event green."""
        return all(r.ok for r in self.records)

    @property
    def min_served_fraction(self) -> float:
        return min((r.served_fraction for r in self.records), default=1.0)

    def timeline(self) -> Dict[str, list]:
        """Campaign trajectory as parallel lists (fig/JSON ready)."""
        out: Dict[str, list] = {
            "t": [r.t for r in self.records],
            "kind": [r.kind for r in self.records],
            "served_fraction": [r.served_fraction for r in self.records],
            "l_max": [r.l_max for r in self.records],
            "lost_pairs": [r.lost_pairs for r in self.records],
            "mttr_s": [r.mttr_s for r in self.records],
            "flows_rerouted": [r.flows_rerouted for r in self.records],
        }
        if any(r.probe is not None for r in self.records):
            base = (self.baseline_probe or {}).get("delivered", 0.0)
            out["throughput_retained"] = [
                None if r.probe is None else
                (r.probe["delivered"] / base if base else None)
                for r in self.records]
        return out

    def fingerprint(self) -> Tuple:
        """Condensed campaign outcome for bit-identical replay checks:
        the final table's hop/VC arrays digested (process-stable CRC,
        not python ``hash`` which is salted per process) with every
        per-event counter. Two runs from the same seed must match."""
        tab = self.state.table
        return (tuple((r.kind, r.n_channels, r.coalesced,
                       r.flows_rerouted, r.lost_pairs, r.l_max)
                      for r in self.records),
                zlib.crc32(tab.chan.tobytes()),
                zlib.crc32(tab.vc.tobytes()),
                zlib.crc32(tab.hop_indptr.tobytes()))


def probe_throughput(state: ServingState, rate: float = 0.05,
                     cycles: int = 1200, warmup: int = 400,
                     seed: int = 0, device=None) -> dict:
    """One netsim saturation probe of the current serving table. A
    degraded table is compacted first (the kernel samples traffic over
    flow slots and cannot inject into a lost pair); the probe reports
    the watchdog outputs alongside delivered throughput. ``device``
    (``None`` = CUDA, which raises when no GPU is present) holds the
    simulator."""
    from repro_torch.core import netsim as NS
    if len(state.lost):
        tab, _ = state.table.compact()
    else:
        tab = state.table
    stats: dict = {}
    r = NS.sweep(NS.build_tables(state.topo, tab), [rate], cycles=cycles,
                 warmup=warmup, seed=seed, stats=stats,
                 device=device)[0]
    return {"rate": float(rate), "delivered": float(r["delivered"]),
            "offered": float(r["offered"]),
            "stalled_at": int(r["stalled_at"]),
            "cycles_run": int(stats.get("cycles_run", cycles)),
            "served_flows": int(tab.n_flows)}


def run_campaign(state: ServingState, schedule: ChaosSchedule,
                 coalesce: float = 1.0, probe_every: int = 0,
                 probe_rate: float = 0.05, probe_cycles: int = 1200,
                 probe_warmup: int = 400, rebalance: bool = True,
                 check_untouched: bool = True,
                 device=None) -> CampaignResult:
    """Drive a live :class:`ServingState` through a fault/heal
    timeline. Fault arrivals within ``coalesce`` time units of each
    other merge into ONE repair pool (storm semantics: the repair sees
    the union of their dead channels, so overlapping arrivals cost one
    incremental repair, not one per event); restores never merge with
    faults. After every event the full invariant suite runs
    (:func:`check_invariants`) and, every ``probe_every`` events (0 =
    never), a netsim throughput probe samples the degraded fabric, on
    ``device`` (``None`` = CUDA, which raises when no GPU is present).

    Pure with respect to the input state (repairs/restores are pure),
    and deterministic: same state + same schedule => bit-identical
    result (:meth:`CampaignResult.fingerprint`).
    """
    groups: List[List[ChaosEvent]] = []
    for ev in sorted(schedule.events, key=lambda e: e.t):
        if (groups and ev.kind != "restore"
                and groups[-1][-1].kind != "restore"
                and ev.t - groups[-1][-1].t <= coalesce):
            groups[-1].append(ev)
        else:
            groups.append([ev])

    baseline_probe = None
    if probe_every:
        baseline_probe = probe_throughput(
            state, rate=probe_rate, cycles=probe_cycles,
            warmup=probe_warmup, seed=schedule.seed, device=device)
    cur = state
    records: List[EventRecord] = []
    for gi, g in enumerate(groups):
        chans = np.unique(np.concatenate([e.channels for e in g]))
        t0 = time.time()
        if g[0].kind == "restore":
            rr = restore_channels(cur, chans, rebalance=rebalance)
            kind = "restore"
        else:
            rr = repair_fault(cur, chans)
            kind = "storm" if len(g) > 1 else g[0].kind
        mttr = time.time() - t0
        inv = check_invariants(cur, rr, untouched=check_untouched)
        cur = rr.state
        rec = EventRecord(
            t=float(g[-1].t), kind=kind, n_channels=int(len(chans)),
            coalesced=len(g), mttr_s=round(mttr, 3),
            flows_rerouted=int(rr.flows_rerouted),
            lost_pairs=int(rr.lost),
            served_fraction=float(cur.served_fraction),
            l_max=float(rr.l_max), fallback=bool(rr.fallback),
            readmitted=int(rr.readmitted), invariants=inv)
        if probe_every and ((gi + 1) % probe_every == 0
                            or gi == len(groups) - 1):
            rec.probe = probe_throughput(
                cur, rate=probe_rate, cycles=probe_cycles,
                warmup=probe_warmup, seed=schedule.seed, device=device)
        records.append(rec)
    return CampaignResult(schedule, records, cur,
                          baseline_l_max=float(state.l_max),
                          baseline_probe=baseline_probe)
