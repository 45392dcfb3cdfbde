"""Pluggable traffic patterns for the cycle-level simulator.

Port copy of ``repro.core.traffic``: numpy on the host, unchanged.

The paper evaluates uniform-random and all-to-all traffic only; related
work (TopoOpt's parallelization-derived traffic, UB-Mesh's hierarchically
localized patterns) shows traffic diversity is decisive when comparing
topologies. A :class:`TrafficPattern` is an (n, n) non-negative demand
matrix (zero diagonal) plus per-source relative injection intensities; it
compiles to per-source *alias sampling tables* (Vose's method) so that the
jitted simulator draws a destination in O(1) with two random numbers and
two gathers -- the same kernel serves every pattern, only the table
contents change (no per-pattern recompilation).

Built-in patterns:

- ``uniform``      -- uniform-random over all other nodes (paper Fig. 5)
- ``permutation``  -- one fixed partner per source (transpose/complement)
- ``hotspot``      -- a fraction of traffic targets a small hot set
- ``from_demand``  -- weights from a :class:`repro.core.demand.WorkloadDemand`
                      (parallelization-derived: DP rings + in-cube TP/EP)
- ``fault_correlated`` -- demand concentrated around a failed-OCS region
                      (the nodes that lost links): recovery traffic --
                      re-replication, checkpoint restore, re-sharding --
                      clusters exactly where capacity just dropped, the
                      adversarial case for fault re-routing (fig8)

Beyond single stationary patterns (workload co-design):

- :func:`compose_tenants` merges several jobs' sub-pod demand matrices
  (disjoint or overlapping node sets, per-job rate shares) into one
  pattern carrying a :class:`TenantMap`, and the sim kernels account
  injected/consumed/in-flight packets *per tenant*;
- :class:`PhasedTraffic` replays a recorded collective trace as a cyclic
  schedule of demand phases -- the spatial pattern itself switches over
  time (MoE all-to-all -> DP all-reduce -> background), complementing
  :class:`BurstSchedule` which only modulates intensity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CompiledTraffic:
    """Alias tables ready for the jitted kernel (device-transferable)."""
    prob: np.ndarray        # (n, n) float32: alias acceptance probability
    alias: np.ndarray       # (n, n) int32: alias destination
    src_rate: np.ndarray    # (n,) float32: relative injection rate, mean 1

    def row_probs(self) -> np.ndarray:
        """Exact (n, n) sampling distribution the alias tables encode
        (each row sums to 1 for live rows): the inverse of
        :func:`_alias_tables`, used to re-target a compiled pattern onto
        a different sampling domain (e.g. CSR flow slots)."""
        n = self.prob.shape[0]
        p = self.prob.astype(np.float64) / n
        rows = np.repeat(np.arange(n), n)
        np.add.at(p, (rows, self.alias.reshape(-1)),
                  ((1.0 - self.prob.astype(np.float64)) / n).reshape(-1))
        return p


def _alias_tables_ragged(w: np.ndarray,
                         deg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias construction over ragged rows, batched.

    ``w`` is (R, W) non-negative weights where only the first ``deg[r]``
    columns of row ``r`` are real; padding columns never enter the
    stacks and keep (prob 0, alias = own column). Rows with zero mass
    get a degenerate self-alias table (prob 0, alias = own column: a
    draw deterministically returns the drawn slot) and must be masked by
    ``src_rate == 0`` on the caller side.

    Every row keeps its small/large stacks as columns of shared (R, W)
    index arrays with per-row tops, and each loop iteration retires one
    small entry of *every* unfinished row: <= 2W vectorised iterations
    total, identical alias-table semantics to the per-row scalar loop.
    """
    R, W = w.shape
    prob = np.zeros((R, W), np.float32)
    alias = np.broadcast_to(np.arange(W, dtype=np.int32), (R, W)).copy()
    colm = np.arange(W)[None, :] < np.asarray(deg)[:, None]
    wv = np.where(colm, w, 0.0)
    total = wv.sum(axis=1, dtype=np.float64)
    live = total > 0
    if not live.any():
        return prob, alias
    livec = live[:, None] & colm
    q = np.zeros((R, W), np.float64)
    q[livec] = (wv * (np.asarray(deg, np.float64)[:, None]
                      / np.where(live, total, 1.0)[:, None]))[livec]
    prob[livec] = 1.0
    small_mask = (q < 1.0) & livec
    large_mask = (q >= 1.0) & livec
    # left-aligned per-row stacks: first `top` entries are the stack,
    # ascending index order (stable argsort of the mask), top = last
    st_small = np.argsort(~small_mask, kind="stable", axis=1) \
        .astype(np.int32)
    st_large = np.argsort(~large_mask, kind="stable", axis=1) \
        .astype(np.int32)
    top_s = small_mask.sum(axis=1).astype(np.int64)
    top_l = large_mask.sum(axis=1).astype(np.int64)
    while True:
        act = np.nonzero((top_s > 0) & (top_l > 0))[0]
        if not len(act):
            break
        s = st_small[act, top_s[act] - 1]
        l = st_large[act, top_l[act] - 1]
        qs = q[act, s]
        prob[act, s] = qs
        alias[act, s] = l
        ql = q[act, l] - (1.0 - qs)
        q[act, l] = ql
        top_s[act] -= 1
        # a large that dropped below 1 moves onto the small stack
        demote = act[ql < 1.0]
        if len(demote):
            st_small[demote, top_s[demote]] = st_large[demote,
                                                       top_l[demote] - 1]
            top_s[demote] += 1
            top_l[demote] -= 1
    # leftovers on either stack accept directly (prob stays 1)
    return prob, alias


def _alias_tables(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Square (n, n) Vose construction: every column of every row is a
    real slot (the classic per-destination tables). Thin wrapper over the
    ragged builder, preserving the historical degenerate-row encoding
    (zero-mass rows get alias 0 rather than self-alias)."""
    n = w.shape[0]
    prob, alias = _alias_tables_ragged(w, np.full(n, n, np.int64))
    dead = w.sum(axis=1) <= 0
    alias[dead] = 0
    return prob, alias


@dataclasses.dataclass(frozen=True)
class BurstSchedule:
    """Deterministic on/off injection modulation (time-varying traffic).

    Each source's injection probability is multiplied by ``gain`` during
    the first ``round(duty * period)`` cycles of its period (offset by
    ``phase[src]``) and by the compensating off-gain
    ``(1 - duty * gain) / (1 - duty)`` the rest -- mean-preserving by
    construction, so bursty and steady sweeps at the same nominal rate
    offer the same long-run load and their saturation points stay
    comparable. ``phase=None`` synchronises every source (the hardest
    case: the whole fabric bursts together); pass per-source offsets to
    stagger.
    """
    period: int
    duty: float
    gain: float
    phase: Optional[np.ndarray] = None   # (n,) int cycle offsets

    def __post_init__(self):
        if self.period < 2:
            raise ValueError("burst period must be >= 2 cycles")
        if not 0.0 < self.duty < 1.0:
            raise ValueError("burst duty must be in (0, 1)")
        if not 1.0 <= self.gain <= 1.0 / self.duty + 1e-9:
            raise ValueError(f"burst gain must be in [1, 1/duty] "
                             f"(got {self.gain}, duty {self.duty}); the "
                             f"off-phase gain would go negative")

    def realize(self, n: int):
        """(on_cycles, g_on, g_off, phase array) for the kernel, with
        the duty re-derived from the integer on-window so the mean is
        preserved exactly."""
        on = int(np.clip(round(self.duty * self.period), 1,
                         self.period - 1))
        duty = on / self.period
        g_on = float(self.gain)
        g_off = (1.0 - duty * g_on) / (1.0 - duty)
        if g_off < 0:
            raise ValueError(f"burst gain {self.gain} too high for the "
                             f"realized duty {duty:.3f}")
        if self.phase is None:
            phase = np.zeros(n, np.int32)
        else:
            phase = np.asarray(self.phase, np.int32) % self.period
            if phase.shape != (n,):
                raise ValueError(f"burst phase must be ({n},)")
        return on, g_on, g_off, phase


@dataclasses.dataclass(frozen=True)
class CompiledFlowTraffic:
    """Alias tables over the *flow slots* of a CSR path table.

    Where :class:`CompiledTraffic` samples a destination node from
    (n, n) tables, this samples a routed flow id directly from flat
    (F,) tables aligned with ``CSRPathTable``'s row-major flow order:
    draw a slot ``j`` uniformly in ``[0, deg[s])``, then accept
    ``src_indptr[s] + j`` or take its alias. Demand on unrouted pairs is
    dropped at compile time (each live row renormalises over its routed
    flows), so offered traffic is always injectable; memory is O(F), not
    O(n^2) -- the sampling-side counterpart of the CSR simulator kernel.
    ``burst`` (when set) rides along from the source pattern and makes
    the kernel modulate injection thresholds over time.

    Compiled from a :class:`PhasedTraffic`, ``phases`` is P > 0 and
    ``prob``/``alias``/``src_rate`` grow a leading phase axis --
    (P, F)/(P, F)/(P, n) -- with ``phase_of`` mapping cycle-in-period to
    phase index; stationary patterns keep the flat shapes with
    ``phases == 0``. ``tenants`` (from :func:`compose_tenants`) rides
    along for the kernels' per-tenant packet accounting.
    """
    n: int
    src_indptr: np.ndarray  # (n + 1,) int32: flow range of each source
    deg: np.ndarray         # (n,) int32: routed flow count per source
    prob: np.ndarray        # (F,) float32 -- or (P, F) when phased
    alias: np.ndarray       # (F,) int32 alias flow id -- or (P, F)
    src_rate: np.ndarray    # (n,) float32 -- or (P, n) when phased
    burst: Optional[BurstSchedule] = None
    tenants: Optional[TenantMap] = None
    phases: int = 0                          # P; 0 = stationary
    phase_of: Optional[np.ndarray] = None    # (period,) int32 when phased


def compile_flow_traffic(traffic, src_indptr: np.ndarray,
                         dst: np.ndarray,
                         block: int = 2048) -> CompiledFlowTraffic:
    """Compile a traffic pattern onto a CSR flow space.

    ``traffic`` is a :class:`TrafficPattern`, a :class:`CompiledTraffic`
    (re-targeted exactly via :meth:`CompiledTraffic.row_probs`), a
    :class:`PhasedTraffic` (each phase compiled independently and
    stacked along a leading axis), or ``None`` for uniform.
    ``src_indptr``/``dst`` come straight from the ``CSRPathTable``. Rows
    are processed in blocks of ``block`` sources so the padded
    (block, max_deg) staging arrays stay small at 4096 chips.
    """
    if isinstance(traffic, PhasedTraffic):
        parts = [compile_flow_traffic(p, src_indptr, dst, block=block)
                 for p in traffic.patterns]
        phase_of = np.repeat(
            np.arange(len(parts), dtype=np.int32),
            np.asarray(traffic.cycles, np.int64))
        c0 = parts[0]
        return CompiledFlowTraffic(
            c0.n, c0.src_indptr, c0.deg,
            np.stack([c.prob for c in parts]),
            np.stack([c.alias for c in parts]),
            np.stack([c.src_rate for c in parts]),
            burst=traffic.burst, tenants=traffic.tenants,
            phases=len(parts), phase_of=phase_of)
    n = len(src_indptr) - 1
    F = len(dst)
    sptr = np.asarray(src_indptr, np.int64)
    deg = np.diff(sptr).astype(np.int32)
    prob = np.ones(F, np.float32)
    alias = np.arange(F, dtype=np.int32)
    if traffic is None:
        # uniform over routed flows: all weights equal -> every slot is
        # exactly "large" (q == 1) and accepts directly; skip the (n, n)
        # matrix entirely (134 MB at 16^3)
        return CompiledFlowTraffic(n, sptr.astype(np.int32), deg, prob,
                                   alias, np.ones(n, np.float32))
    burst = None
    tenants = None
    if isinstance(traffic, CompiledTraffic):
        matrix = traffic.row_probs()
        src_rate = np.asarray(traffic.src_rate, np.float32)
    else:
        matrix = traffic.matrix
        src_rate = np.asarray(traffic.src_rate, np.float32)
        burst = traffic.burst
        tenants = traffic.tenants
    if matrix.shape[0] != n:
        raise ValueError(f"pattern over {matrix.shape[0]} nodes, table "
                         f"over {n}")
    dst64 = np.asarray(dst, np.int64)
    for s0 in range(0, n, block):
        s1 = min(s0 + block, n)
        f0, f1 = int(sptr[s0]), int(sptr[s1])
        if f1 == f0:
            continue
        degb = deg[s0:s1].astype(np.int64)
        Wb = int(degb.max())
        colm = np.arange(Wb)[None, :] < degb[:, None]
        wpad = np.zeros((s1 - s0, Wb), np.float64)
        flow_src = np.repeat(np.arange(s0, s1), degb)
        wpad[colm] = matrix[flow_src, dst64[f0:f1]]
        p, a = _alias_tables_ragged(wpad, degb)
        prob[f0:f1] = p[colm]
        alias[f0:f1] = (sptr[s0:s1, None].astype(np.int64)
                        + a.astype(np.int64))[colm].astype(np.int32)
    return CompiledFlowTraffic(n, sptr.astype(np.int32), deg, prob, alias,
                               src_rate, burst=burst, tenants=tenants)


@dataclasses.dataclass
class TrafficPattern:
    """Demand matrix + per-source intensity; compiles to alias tables.

    ``burst`` attaches a :class:`BurstSchedule`: the *spatial* pattern
    (who talks to whom) is unchanged, only the injection intensity
    becomes time-varying in the kernel."""
    name: str
    matrix: np.ndarray          # (n, n) float64, zero diagonal
    src_rate: Optional[np.ndarray] = None   # (n,), defaults to row-mass/mean
    burst: Optional[BurstSchedule] = None
    tenants: Optional["TenantMap"] = None   # set by compose_tenants

    def __post_init__(self):
        m = np.asarray(self.matrix, np.float64).copy()
        np.fill_diagonal(m, 0.0)
        self.matrix = m
        if self.src_rate is None:
            mass = m.sum(axis=1)
            mean = mass[mass > 0].mean() if (mass > 0).any() else 1.0
            self.src_rate = (mass / mean).astype(np.float32)
        else:
            self.src_rate = np.asarray(self.src_rate, np.float32)

    @property
    def n(self) -> int:
        return self.matrix.shape[0]

    def compiled(self) -> CompiledTraffic:
        prob, alias = _alias_tables(self.matrix)
        return CompiledTraffic(prob, alias,
                               np.asarray(self.src_rate, np.float32))

    def with_burst(self, period: int, duty: float = 0.25,
                   gain: float = 3.0,
                   phase: Optional[np.ndarray] = None) -> "TrafficPattern":
        """Same spatial pattern, bursty in time (mean-preserving):
        ``gain``x injection for ``duty`` of each ``period``, compensated
        the rest. Returns a new pattern; the original is untouched."""
        return TrafficPattern(f"{self.name}+burst{period}", self.matrix,
                              src_rate=self.src_rate,
                              burst=BurstSchedule(period, duty, gain,
                                                  phase),
                              tenants=self.tenants)

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def uniform(n: int) -> "TrafficPattern":
        m = np.ones((n, n), np.float64)
        return TrafficPattern("uniform", m)

    @staticmethod
    def permutation(perm: Sequence[int],
                    name: str = "permutation") -> "TrafficPattern":
        """One destination per source; fixed points inject nothing."""
        perm = np.asarray(perm, np.int64)
        n = len(perm)
        m = np.zeros((n, n), np.float64)
        src = np.arange(n)
        ok = perm != src
        m[src[ok], perm[ok]] = 1.0
        return TrafficPattern(name, m)

    @staticmethod
    def transpose(pod) -> "TrafficPattern":
        """Coordinate-transpose permutation (x, y, z) -> (z, y, x) when the
        pod is axis-symmetric; otherwise the coordinate complement
        (x, y, z) -> (X-1-x, Y-1-y, Z-1-z), which is a fixed-point-free
        permutation on any pod shape."""
        X, Y, Z = pod.dims
        coords = pod.all_coords()
        if X == Z:
            perm = coords[:, 2] + X * (coords[:, 1] + Y * coords[:, 0])
            return TrafficPattern.permutation(perm, name="transpose")
        comp = np.array(pod.dims) - 1 - coords
        perm = comp[:, 0] + X * (comp[:, 1] + Y * comp[:, 2])
        return TrafficPattern.permutation(perm, name="transpose")

    @staticmethod
    def hotspot(n: int, hot: Optional[Sequence[int]] = None,
                frac: float = 0.5) -> "TrafficPattern":
        """``frac`` of each source's traffic targets the hot set uniformly,
        the rest is uniform-random over the non-hot nodes."""
        if hot is None:
            hot = [0]
        hot = np.asarray(sorted(set(int(h) for h in hot)), np.int64)
        cold = np.ones((n, n), np.float64)
        cold[:, hot] = 0.0
        np.fill_diagonal(cold, 0.0)
        cold_mass = cold.sum(axis=1, keepdims=True)
        m = cold / np.maximum(cold_mass, 1e-12) * (1.0 - frac)
        hotm = np.zeros((n, n), np.float64)
        hotm[:, hot] = 1.0
        np.fill_diagonal(hotm, 0.0)
        hot_mass = hotm.sum(axis=1, keepdims=True)
        m = m + hotm / np.maximum(hot_mass, 1e-12) * frac
        return TrafficPattern(f"hotspot{len(hot)}", m,
                              src_rate=np.ones(n, np.float32))

    @staticmethod
    def fault_correlated(n: int, region: Sequence[int],
                         frac: float = 0.5,
                         src_boost: float = 2.0) -> "TrafficPattern":
        """Demand concentrated on a failed-OCS region.

        ``region`` is the set of nodes that lost links to the fault
        (see :func:`repro.core.fault.fault_region_nodes`). Every source
        sends ``frac`` of its traffic uniformly into the region and the
        rest uniformly elsewhere -- recovery flows (re-replication,
        checkpoint restore) target the impaired machines -- while
        sources inside the region inject ``src_boost`` times the
        baseline rate (they also re-send what the dead links dropped).
        """
        region = np.asarray(sorted(set(int(r) for r in region)), np.int64)
        if not len(region) or len(region) >= n:
            raise ValueError("fault region must be a proper non-empty "
                             "subset of the nodes")
        inm = np.zeros((n, n), np.float64)
        inm[:, region] = 1.0
        np.fill_diagonal(inm, 0.0)
        out = np.ones((n, n), np.float64)
        out[:, region] = 0.0
        np.fill_diagonal(out, 0.0)
        in_mass = inm.sum(axis=1, keepdims=True)
        out_mass = out.sum(axis=1, keepdims=True)
        m = inm / np.maximum(in_mass, 1e-12) * frac \
            + out / np.maximum(out_mass, 1e-12) * (1.0 - frac)
        rate = np.ones(n, np.float32)
        rate[region] = src_boost
        return TrafficPattern(f"fault{len(region)}", m, src_rate=rate)

    @staticmethod
    def from_demand(wd) -> "TrafficPattern":
        """Weights from a WorkloadDemand (repro.core.demand): DP all-reduce
        rings across cubes + TP/EP all-to-all inside cubes + uniform floor,
        i.e. traffic derived from the job's parallelization strategy."""
        return TrafficPattern("demand", wd.matrix())

    @staticmethod
    def from_matrix(name: str, matrix: np.ndarray,
                    src_rate: Optional[np.ndarray] = None) -> "TrafficPattern":
        return TrafficPattern(name, matrix, src_rate)

    @staticmethod
    def from_trace(n: int, trace: Sequence[Tuple[int, int, int]],
                   name: str = "trace") -> "TrafficPattern":
        """Demand from a recorded collective trace -- a sequence of
        ``(src, dst, n_chunks)`` transfers as emitted by
        :func:`repro.core.collectives.a2a_trace`. Chunk counts on the
        same pair accumulate."""
        m = np.zeros((n, n), np.float64)
        if len(trace):
            t = np.asarray([(s, d, c) for s, d, c in trace], np.int64)
            np.add.at(m, (t[:, 0], t[:, 1]), t[:, 2].astype(np.float64))
        return TrafficPattern(name, m)


# ---------------------------------------------------------------------------
# Multi-tenant composition: several jobs sharing one fabric
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One job in a shared pod: demand over its own node subset.

    ``matrix`` is (m, m) over ``nodes`` order (m = len(nodes));
    ``rate_share`` is the job's relative injection intensity -- a
    tenant's per-source demand mass is normalised to ``rate_share``, so
    two tenants with shares 1.0 and 0.5 offer a 2:1 per-node load ratio
    regardless of how their raw matrices were scaled.
    """
    name: str
    nodes: np.ndarray
    matrix: np.ndarray
    rate_share: float = 1.0


@dataclasses.dataclass(frozen=True)
class TenantMap:
    """Per-pair tenant attribution for a composed multi-job pattern.

    ``pair_tenant[s, d]`` is the tenant id whose demand dominates the
    (s, d) pair, -1 for pairs no tenant uses. For disjoint node sets the
    attribution is exact (each pair belongs to at most one tenant); for
    overlapping sets a shared pair is attributed to its dominant
    contributor (argmax of composed weight), an approximation the
    per-tenant counters inherit and the docstrings of
    :func:`compose_tenants` call out.
    """
    names: Tuple[str, ...]
    pair_tenant: np.ndarray     # (n, n) int32, -1 = unattributed
    n_nodes: Tuple[int, ...]    # node-set size per tenant

    @property
    def n_tenants(self) -> int:
        return len(self.names)


def compose_tenants(n: int,
                    tenants: Sequence[TenantSpec]) -> TrafficPattern:
    """Compose per-job sub-pod demands into one fabric-wide pattern.

    Each tenant's matrix is embedded at its global node ids, normalised
    so its mean per-source mass equals ``rate_share``, and summed.
    ``src_rate`` becomes each node's summed share (so a node serving two
    jobs injects both jobs' load); the returned pattern carries a
    :class:`TenantMap` that the sim kernels use for per-tenant
    injected/consumed/in-flight accounting (exact packet conservation
    per tenant -- every injected packet is consumed or still queued).
    """
    if not tenants:
        raise ValueError("need at least one tenant")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    total = np.zeros((n, n), np.float64)
    best = np.zeros((n, n), np.float64)
    pair = np.full((n, n), -1, np.int32)
    share = np.zeros(n, np.float64)
    for t_id, t in enumerate(tenants):
        nodes = np.asarray(t.nodes, np.int64)
        m = len(nodes)
        if m < 2 or len(np.unique(nodes)) != m:
            raise ValueError(f"tenant {t.name!r}: nodes must be >= 2 "
                             f"unique ids")
        if nodes.min() < 0 or nodes.max() >= n:
            raise ValueError(f"tenant {t.name!r}: node ids outside "
                             f"[0, {n})")
        sub = np.asarray(t.matrix, np.float64).copy()
        if sub.shape != (m, m):
            raise ValueError(f"tenant {t.name!r}: matrix {sub.shape} vs "
                             f"{m} nodes")
        np.fill_diagonal(sub, 0.0)
        if (sub < 0).any():
            raise ValueError(f"tenant {t.name!r}: negative demand")
        mass = sub.sum()
        if mass <= 0:
            raise ValueError(f"tenant {t.name!r}: zero demand mass")
        w = sub / mass * (float(t.rate_share) * m)
        ix = np.ix_(nodes, nodes)
        total[ix] += w
        blk = best[ix]
        pblk = pair[ix]
        take = w > blk
        pblk[take] = t_id
        pair[ix] = pblk
        best[ix] = np.maximum(blk, w)
        share[nodes] += float(t.rate_share)
    live = share > 0
    src_rate = (share / share[live].mean()).astype(np.float32)
    tmap = TenantMap(tuple(names), pair,
                     tuple(len(np.asarray(t.nodes)) for t in tenants))
    name = "tenants:" + "+".join(names)
    return TrafficPattern(name, total, src_rate=src_rate, tenants=tmap)


# ---------------------------------------------------------------------------
# Trace-driven replay: cyclic schedule of demand phases
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhasedTraffic:
    """A recorded collective trace as a cyclic demand schedule.

    Where :class:`BurstSchedule` modulates injection *intensity* under a
    fixed spatial pattern, a PhasedTraffic switches the spatial demand
    itself: phase ``p`` runs ``cycles[p]`` sim cycles with
    ``patterns[p]``'s matrix and source rates, then the schedule wraps.
    This replays a training step's collective sequence (e.g. MoE
    all-to-all -> DP all-reduce ring -> background) against the fabric
    instead of a stationary average. Compiles per phase onto the CSR
    flow slots; the kernel indexes the phase by cycle with the same RNG
    draw count as the stationary path, so a single-phase schedule is
    bit-identical to its stationary pattern. ``burst`` (optional)
    modulates intensity on top of the phase schedule; ``tenants``
    attributes pairs for per-tenant accounting (phase-independent).
    """
    name: str
    patterns: Tuple[TrafficPattern, ...]
    cycles: Tuple[int, ...]
    burst: Optional[BurstSchedule] = None
    tenants: Optional[TenantMap] = None

    def __post_init__(self):
        if not self.patterns or len(self.patterns) != len(self.cycles):
            raise ValueError("need one cycle count per phase pattern")
        if any(int(c) < 1 for c in self.cycles):
            raise ValueError("every phase must last >= 1 cycle")
        if len({p.n for p in self.patterns}) != 1:
            raise ValueError("all phase patterns must cover the same "
                             "node count")

    @property
    def n(self) -> int:
        return self.patterns[0].n

    @property
    def period(self) -> int:
        return int(sum(self.cycles))
