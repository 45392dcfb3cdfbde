"""TONS topology synthesis: the dualized LR LP with edge variables.

Implements Table 1 of the paper over *our* (validated) MCF conventions:

  primal (P):  min  sum_p m_p d_p
               s.t. sum_{unordered pairs p} d_p >= 1            [lambda]
                    d_ij - d_ik - d_kj <= 0,
                        ordered triples, (i,k) in L_valid       [y_ijk]
                    d >= 0
  dual (TONS): max lambda
               s.t. for every unordered pair {a,b}:
                    lambda - sum_{k in Lv(a)} y[a,b,k]
                           - sum_{k in Lv(b)} y[b,a,k]
                           + [ (a,b) in Lv ] ( sum_j y[a,j,b]
                                             + sum_j y[b,j,a] )
                           + sum_{i in Lv(a)} y[i,b,a]
                           + sum_{i in Lv(b)} y[i,a,b]
                           <= m_ab
               lambda, y >= 0;  m in [0,1] constrained by C3 (one circuit
               per OCS port) with electrical m fixed to 1.

Scaling reductions: one-leg (y only for (i,k) in L_valid), edge/vertex
symmetry (cube translations collapse y to canonical sources and m to edge
orbits; constraints only for canonical pair classes), and Algorithm 3's
iterative LP relaxation with greedy integer fixing.

Engineering: the LP rows/columns are assembled as ragged-CSR
cross-products (``engine="batched"``) -- no per-pair python loops. The
greedy fixing loop
is batched: each LP re-solve fixes a *block* of mutually port-compatible
orbit variables (warm-started PDHG between rounds), and a final
edge-granularity matching completion fills any ports the orbit-level
greedy could not cover, so synthesized pods always come out radix-6.
``SynthesisResult.to_topology`` + :func:`evaluate_end_to_end` wire the
synthesized edge set through the full stack: ``Channels.from_topology``
-> ``allowed_turns`` -> ``select_paths(engine="sharded")`` -> VC
allocation -> deadlock-free verification -> (optional) netsim saturation.

Port of ``repro.core.synthesis``: the batched LP assembly and the greedy
fixing loop are host numpy, unchanged; PDHG rounds run their chunk loop
on ``device`` (:func:`repro_torch.core.lp.solve_pdhg`), and
:func:`evaluate_end_to_end` routes on the port's pipeline (APL
priorities on the (min,+) APSP kernel) and simulates on the port's
netsim. The seed's per-pair assembly (``engine="reference"``) is the
reference package's oracle and is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.lp import COOMatrix, solve_highs, solve_pdhg
from repro_torch.core.mcf import PairCanon
from repro_torch.device import resolve_device

# above this variable count the HiGHS oracle stops being competitive on
# this container and synthesize() switches to warm-started PDHG rounds
HIGHS_VAR_CAP = 2_000_000
# above this variable count: loosen the IPM tolerance (the fixing loop
# only consumes the ordering of the fractional m values) and cut the
# number of LP re-solves -- at 8^3 one exact solve is ~4.5 min, and
# matrix-free PDHG needs >10 min to reach a usable gap on this LP
LARGE_LP_VARS = 200_000


@dataclasses.dataclass
class SynthesisLP:
    pod: T.Pod
    pc: PairCanon
    n_var: int
    c: np.ndarray
    A: COOMatrix
    b: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    m_slice: slice                      # m variables within x
    orbit_keys: List[int]               # orbit key per m var
    orbit_members: List[List[Tuple[int, int, int]]]   # (u, v, color)
    port_of: Dict[Tuple[int, int], int]  # (chip, axis) -> port row id


def build_synthesis_lp(pod: T.Pod, symmetric: bool = True,
                       fault_f: Optional[int] = None,
                       pair_weight=None,
                       engine: str = "batched") -> SynthesisLP:
    """Build the dual synthesis LP.

    ``engine="batched"`` (the only engine here) assembles all rows as
    vectorised ragged-CSR cross-products, in the reference's COO order
    with its duplicates kept.
    """
    if engine == "reference":
        raise ValueError("engine='reference' (the seed's per-pair loops) "
                         "is the reference package's oracle "
                         "(repro.core.synthesis) and is not ported")
    if engine != "batched":
        raise ValueError(f"unknown engine {engine!r}")
    return _build_synthesis_lp_batched(pod, symmetric, fault_f, pair_weight)


# ---------------------------------------------------------------------------
# Batched assembly: ragged-CSR cross-products, no per-pair python loops
# ---------------------------------------------------------------------------


def _expand_csr(indptr: np.ndarray, indices: np.ndarray,
                nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-product expansion of CSR rows: for ``nodes[i]`` with degree
    d_i, emit (i repeated d_i times, the d_i neighbors)."""
    deg = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    total = int(deg.sum())
    rr = np.repeat(np.arange(len(nodes), dtype=np.int64), deg)
    base = np.repeat(indptr[nodes].astype(np.int64), deg)
    within = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(deg) - deg, deg)
    return rr, indices[base + within].astype(np.int64)


def _first_occurrence_unique(keys: np.ndarray):
    """(unique keys in first-occurrence order, their first index,
    rank-per-element) -- reproduces python dict insertion-order dedup."""
    uk, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uk), np.int64)
    rank[order] = np.arange(len(uk))
    return uk[order], first[order], rank[inv]


def _build_synthesis_lp_batched(pod: T.Pod, symmetric: bool,
                                fault_f: Optional[int],
                                pair_weight) -> SynthesisLP:
    n = pod.n
    perms = T.cube_translations(pod) if symmetric else \
        np.arange(n, dtype=np.int32)[None, :]
    pc = PairCanon(perms, n, directed=False)
    P = pc.perms
    g_of = pc.node_g
    S = pc.sources.astype(np.int64)

    cu, cv, ccol = T.valid_optical_pairs_arrays(pod)
    elec = T.electrical_edges(pod).astype(np.int64)

    # ---- L_valid adjacency as one deduplicated CSR (sorted neighbors) ----
    eu = np.concatenate([elec[:, 0], elec[:, 1], cu, cv])
    ev = np.concatenate([elec[:, 1], elec[:, 0], cv, cu])
    adj_keys = np.unique(eu.astype(np.int64) * n + ev.astype(np.int64))
    au = adj_keys // n
    av = adj_keys % n
    indptr = np.searchsorted(au, np.arange(n + 1)).astype(np.int64)

    # ---- m variables: orbits of candidate edges (first-occurrence ids) ---
    ckeys = pc.key(cu, cv)
    okeys, _, oid = _first_occurrence_unique(ckeys)
    n_m = len(okeys)
    osort = np.argsort(oid, kind="stable")
    osizes = np.bincount(oid, minlength=n_m)
    orbit_members: List[List[Tuple[int, int, int]]] = []
    mem = np.stack([cu[osort], cv[osort], ccol[osort]], axis=1)
    pos = 0
    for sz in osizes.tolist():
        orbit_members.append(
            [tuple(r) for r in mem[pos:pos + sz].tolist()])
        pos += sz
    # key -> orbit id lookup over the sorted key array
    okey_sort = np.argsort(okeys, kind="stable")
    okeys_sorted = okeys[okey_sort]

    # ---- y variables: (s, k in Lv[s], j != s,k) for canonical sources ----
    # identical ids to the reference dict: s ascending, k ascending within
    # Lv[s], j ascending with s and k skipped -> block offset arithmetic.
    sdeg = (indptr[S + 1] - indptr[S]).astype(np.int64)
    n_sk = int(sdeg.sum())
    sk_rows = np.repeat(S, sdeg)
    _, sk_cols = _expand_csr(indptr, av, S)
    ypos = np.full((n, n), -1, np.int32)
    ypos[sk_rows, sk_cols] = np.arange(n_sk, dtype=np.int32)
    n_y = n_sk * (n - 2)

    n_var = 1 + n_m + n_y
    m_off, y_off = 1, 1 + n_m

    def yv(i, j, k):
        """Canonicalised y column ids for ordered-triple arrays."""
        g = g_of[i]
        ci = P[g, i]
        cj = P[g, j]
        ck = P[g, k]
        base = ypos[ci, ck].astype(np.int64)
        off = cj - (cj > ci) - (cj > ck)
        return y_off + base * (n - 2) + off

    # ---- canonical unordered pair classes, in the reference row order ----
    aa = np.repeat(S, n)
    bb = np.tile(np.arange(n, dtype=np.int64), len(S))
    keep = aa != bb
    aa, bb = aa[keep], bb[keep]
    pkeys_all = pc.key(aa, bb)
    _, first, _ = _first_occurrence_unique(pkeys_all)
    pa, pb = aa[first], bb[first]
    pkeys = pkeys_all[first]
    R = len(pa)

    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    vals: List[np.ndarray] = []

    def add(rr, cc, vv):
        rows.append(np.asarray(rr, np.int64))
        cols.append(np.asarray(cc, np.int64))
        vals.append(np.asarray(vv, np.float64))

    # lambda coefficient (w == 1 for uniform all-to-all demand)
    if pair_weight is None:
        wab = np.ones(R)
    else:
        wab = np.asarray(pair_weight(pa, pb), np.float64)
        wab = np.where(wab <= 0.0, 0.0, wab)
    add(np.arange(R), np.zeros(R, np.int64), wab)

    # -sum_{k in Lv(x0), k != x1} y[x0, x1, k], both pair orders
    for x0, x1 in ((pa, pb), (pb, pa)):
        rr, kk = _expand_csr(indptr, av, x0)
        m = kk != x1[rr]
        add(rr[m], yv(x0[rr[m]], x1[rr[m]], kk[m]), -np.ones(int(m.sum())))

    # + sum_j y[x0, j, x1] for adjacent pairs only
    adj_mask = np.isin(pa * n + pb, adj_keys)
    radj = np.nonzero(adj_mask)[0]
    if len(radj):
        rr3 = np.repeat(radj, n)
        jj = np.tile(np.arange(n, dtype=np.int64), len(radj))
        m3 = (jj != pa[rr3]) & (jj != pb[rr3])
        rr3, jj = rr3[m3], jj[m3]
        for x0, x1 in ((pa, pb), (pb, pa)):
            add(rr3, yv(x0[rr3], jj, x1[rr3]), np.ones(len(jj)))

    # + sum_{i in Lv(x1), i != x0} y[i, x0, x1], both pair orders
    for x0, x1 in ((pa, pb), (pb, pa)):
        rr, ii = _expand_csr(indptr, av, x1)
        m = ii != x0[rr]
        add(rr[m], yv(ii[m], x0[rr[m]], x1[rr[m]]), np.ones(int(m.sum())))

    # -m[orbit] for candidate pair classes; rhs 1 for electrical pairs
    is_cand = np.isin(pkeys, okeys_sorted)
    rc = np.nonzero(is_cand)[0]
    coid = okey_sort[np.searchsorted(okeys_sorted, pkeys[rc])]
    add(rc, m_off + coid, -np.ones(len(rc)))
    ekeys = np.sort(np.minimum(elec[:, 0], elec[:, 1]) * n +
                    np.maximum(elec[:, 0], elec[:, 1]))
    b_pairs = np.isin(np.minimum(pa, pb) * n + np.maximum(pa, pb),
                      ekeys).astype(np.float64)

    # ---- C3: one circuit per canonical port (equality as two ineqs) ------
    is_canon = np.zeros(n, bool)
    is_canon[S] = True
    caxis = (ccol // T.N_POS).astype(np.int64)
    ends_chip = np.concatenate([cu.astype(np.int64), cv.astype(np.int64)])
    ends_axis = np.concatenate([caxis, caxis])
    ends_oid = np.concatenate([oid, oid])
    sel = is_canon[ends_chip]
    pkey = ends_chip[sel] * 3 + ends_axis[sel]
    poid = ends_oid[sel]
    combo = pkey * n_m + poid
    ucombo, ucnt = np.unique(combo, return_counts=True)
    gp, go = ucombo // n_m, ucombo % n_m
    port_ids = np.unique(gp)                 # sorted == seed's sorted items
    gidx = np.searchsorted(port_ids, gp)
    r3 = R + 2 * gidx
    add(r3, m_off + go, ucnt.astype(np.float64))
    add(r3 + 1, m_off + go, -ucnt.astype(np.float64))
    b3 = np.tile([1.0, -1.0], len(port_ids))
    port_of = {(int(p) // 3, int(p) % 3): i
               for i, p in enumerate(port_ids.tolist())}
    r = R + 2 * len(port_ids)

    # ---- C8: fault tolerance lambda >= (f+1)/(32 n) -----------------------
    b_parts = [b_pairs, b3]
    if fault_f is not None:
        add([r], [0], [-1.0])
        b_parts.append(np.array([-(fault_f + 1) / (32.0 * n)]))
        r += 1

    A = COOMatrix.from_triplets(np.concatenate(rows), np.concatenate(cols),
                                np.concatenate(vals), (r, n_var))
    c = np.zeros(n_var)
    c[0] = -1.0  # max lambda
    lo = np.zeros(n_var)
    hi = np.ones(n_var)
    return SynthesisLP(pod, pc, n_var, c, A, np.concatenate(b_parts), lo,
                       hi, slice(m_off, m_off + n_m), okeys.tolist(),
                       orbit_members, port_of)


@dataclasses.dataclass
class SynthesisResult:
    topology: T.Topology
    lambdas: List[float]          # LP objective per greedy iterate
    times: List[float]
    status: str
    n_orbits: int = 0
    n_fixed: int = 0
    n_completed: int = 0          # edges added by the matching completion
    stats: Optional[dict] = None  # LP sizes + per-round solver detail

    @property
    def lp_lambda(self) -> float:
        """Final LP-relaxation objective (upper-bounds the integral MCF
        of the completed topology up to solver tolerance)."""
        return self.lambdas[-1] if self.lambdas else float("nan")

    def to_topology(self) -> T.Topology:
        """The synthesized topology, ready for ``Channels.from_topology``
        -> ``allowed_turns`` -> ``select_paths`` -> VC alloc -> netsim."""
        return self.topology


def synthesize(podspec: Tuple[int, int, int], symmetric: bool = True,
               interval: Optional[int] = None, fault_f: Optional[int] = None,
               prefer: str = "auto", verbose: bool = False,
               max_lp_iters: int = 12000, tol: float = 2e-4,
               pair_weight=None, lp_engine: str = "batched",
               complete: bool = True, target_rounds: int = 10,
               min_frac: float = 0.02, device=None) -> SynthesisResult:
    """Algorithm 3: iterative relaxed LP + batched greedy integral fixing.

    ``interval`` is the number of orbit variables fixed per LP re-solve
    (the paper's interval parameter); ``None`` picks a block size that
    lands the full greedy in ~``target_rounds`` LP solves. Each round
    fixes the top fractional-value orbits that are mutually
    port-compatible; orbits whose value falls below ``min_frac`` are left
    for the next re-solve (fixing zero-value orbits early is how a big
    block loses throughput). PDHG rounds are warm-started from the
    previous solve's primal/dual iterates. ``complete=True`` finishes any
    ports the orbit-level greedy left unmatched with a per-OCS matching
    at edge granularity (breaking orbit symmetry only where the LP left
    no symmetric choice), so the result is always a full radix-6 fabric.
    PDHG rounds run on ``device`` (``None`` = CUDA); HiGHS rounds on the
    host.
    """
    pod = T.Pod(podspec)
    t0 = time.time()
    lp = build_synthesis_lp(pod, symmetric=symmetric, fault_f=fault_f,
                            pair_weight=pair_weight, engine=lp_engine)
    t_build = time.time() - t0
    lo, hi = lp.lo.copy(), lp.hi.copy()
    n_m = lp.m_slice.stop - lp.m_slice.start
    n = pod.n

    # ---- vectorised orbit/port bookkeeping -------------------------------
    osizes = np.array([len(m) for m in lp.orbit_members], np.int64)
    flat = np.array([(u, v, c) for mem in lp.orbit_members
                     for (u, v, c) in mem], np.int64).reshape(-1, 3)
    maxis = flat[:, 2] // T.N_POS
    # per-orbit port list (chip * 3 + axis), orbit-major
    op_ports = np.stack([flat[:, 0] * 3 + maxis,
                         flat[:, 1] * 3 + maxis], axis=1).ravel()
    op_oid = np.repeat(np.arange(n_m), 2 * osizes)
    op_indptr = np.searchsorted(op_oid, np.arange(n_m + 1))
    # reverse map: port -> orbits touching it
    psort = np.argsort(op_ports, kind="stable")
    rev_ports = op_ports[psort]
    rev_oid = op_oid[psort]
    rev_indptr = np.searchsorted(rev_ports, np.arange(3 * n + 1))
    # orbits whose own members already collide on a port can never be
    # integral (C3 caps them at 1/2) -- block them up front
    dup = np.zeros(n_m, bool)
    okey = op_oid * (3 * n) + op_ports
    oks = np.sort(okey)
    same = oks[1:] == oks[:-1]
    dup[(oks[1:] // (3 * n))[same]] = True

    used = np.zeros(3 * n, bool)
    fixed = np.zeros(n_m, bool)
    blocked = dup.copy()
    hi[lp.m_slice][blocked] = 0.0

    def fix(oi: int) -> None:
        fixed[oi] = True
        lo[lp.m_slice][oi] = hi[lp.m_slice][oi] = 1.0
        pts = op_ports[op_indptr[oi]:op_indptr[oi + 1]]
        used[pts] = True
        for p in pts.tolist():
            aff = rev_oid[rev_indptr[p]:rev_indptr[p + 1]]
            nb = aff[~fixed[aff]]
            blocked[nb] = True
            hi[lp.m_slice][nb] = 0.0

    def live_feasible(oi: int) -> bool:
        return not fixed[oi] and not blocked[oi] and \
            not used[op_ports[op_indptr[oi]:op_indptr[oi + 1]]].any()

    if interval is None:
        # aim for ~target_rounds LP solves: estimate the total number of
        # orbit fixes as ports / (2 * mean orbit size); large instances
        # (expensive solves) get a third of the rounds
        mean_sz = max(float(osizes.mean()) if n_m else 1.0, 1.0)
        n_ports = int((rev_indptr[1:] > rev_indptr[:-1]).sum())
        est_fixes = max(1, int(np.ceil(n_ports / (2.0 * mean_sz))))
        rounds = target_rounds if lp.n_var < LARGE_LP_VARS \
            else max(3, target_rounds // 3)
        interval = max(1, -(-est_fixes // rounds))

    lambdas: List[float] = []
    times: List[float] = []
    solve_log: List[dict] = []
    x_prev = y_prev = None
    status = "ok"
    while True:
        feas = ~fixed & ~blocked
        if not feas.any():
            break
        use_ipm = prefer in ("highs", "ipm") or \
            (prefer == "auto" and lp.n_var < HIGHS_VAR_CAP)
        ts = time.time()
        if use_ipm:
            # interior point (the paper found IPM fastest too, Section 2.3)
            opts = {"ipm_optimality_tolerance": 1e-4} \
                if lp.n_var >= LARGE_LP_VARS else {}
            res = solve_highs(lp.c, lp.A, lp.b, lo, hi, method="highs-ipm",
                              **opts)
        else:
            res = solve_pdhg(lp.c, lp.A, lp.b, lo, hi,
                             max_iters=max_lp_iters, tol=tol,
                             x0=x_prev, y0=y_prev, verbose=False,
                             device=device)
            x_prev, y_prev = res.x, res.y
        solve_log.append({"solver": "highs-ipm" if use_ipm else "pdhg",
                          "s": round(time.time() - ts, 3),
                          "status": res.status,
                          "iters": getattr(res, "iters", 0)})
        lam = -res.obj
        if verbose:
            print(f"  synth it={len(lambdas) + 1} lambda={lam:.6f} "
                  f"fixed={int(fixed.sum())}/{n_m} ({res.status} "
                  f"{solve_log[-1]['s']:.1f}s)")
        if res.status not in ("optimal", "max_iters"):
            # failed solve: don't record its bogus objective as a lambda
            status = res.status
            # fall back to arbitrary feasible completion
            for oi in range(n_m):
                if live_feasible(oi):
                    fix(oi)
            break
        lambdas.append(lam)
        times.append(time.time() - t0)
        mv = res.x[lp.m_slice].copy()
        mv[~feas] = -np.inf
        order = np.argsort(-mv, kind="stable")
        picked = 0
        for oi in order.tolist():
            if picked >= interval:
                break
            if mv[oi] == -np.inf:
                break
            if picked > 0 and mv[oi] < min_frac:
                break   # leave low-value orbits for the next re-solve
            if live_feasible(oi):
                fix(oi)
                picked += 1
        if picked == 0:
            # progress guarantee: the single best feasible orbit
            for oi in order.tolist():
                if mv[oi] == -np.inf:
                    break
                if live_feasible(oi):
                    fix(oi)
                    picked = 1
                    break
        if picked == 0:
            break

    optical = []
    for oi in range(n_m):
        if fixed[oi]:
            optical.extend(lp.orbit_members[oi])

    # ---- matching completion: fill leftover ports per OCS group ----------
    n_completed = 0
    if complete:
        by_color: Dict[int, List[int]] = defaultdict(list)
        for p in T.ports(pod):
            if not used[p.chip * 3 + p.axis]:
                by_color[p.color].append(p.chip)
        for color in sorted(by_color):
            chips = sorted(by_color[color])
            half = len(chips) // 2
            for i in range(half):
                u, v = chips[i], chips[i + half]
                optical.append((min(u, v), max(u, v), color))
                n_completed += 1

    optical = sorted(set(optical))
    topo = T.Topology(pod, optical,
                      name=f"TONS{'_SYM' if symmetric else ''} {podspec}")
    return SynthesisResult(
        topo, lambdas, times, status,
        n_orbits=n_m, n_fixed=int(fixed.sum()), n_completed=n_completed,
        stats={"n_var": lp.n_var, "n_rows": lp.A.shape[0],
               "nnz": len(lp.A.vals), "build_s": round(t_build, 3),
               "interval": int(interval), "solves": solve_log,
               "wall_s": round(time.time() - t0, 3)})


# ---------------------------------------------------------------------------
# End-to-end wiring: synthesized topology -> routed, verified pod
# ---------------------------------------------------------------------------


def evaluate_end_to_end(topo: T.Topology, n_vc: int = 2, K: int = 4,
                        select_engine: str = "sharded",
                        local_search_rounds: int = 2, seed: int = 0,
                        priority: str = "apl", saturation: bool = False,
                        sat_kwargs: Optional[dict] = None,
                        device=None) -> dict:
    """Route a (synthesized) topology through the production pipeline
    (:func:`repro_torch.core.pipeline.route_pod`) and report scalars:
    allowed turns -> path selection -> VC allocation -> deadlock-free
    verification -> (optionally) netsim saturation throughput. The hop
    matrices and the simulator run on ``device`` (``None`` = CUDA).
    """
    from repro_torch.core import netsim as NS, routing as R
    from repro_torch.core.pipeline import PipelineConfig, route_pod

    device = resolve_device(device)
    out: dict = {"n": topo.n, "name": topo.name}
    cfg = PipelineConfig(n_vc=n_vc, K=K, priority=priority, seed=seed,
                         engine=select_engine,
                         local_search_rounds=local_search_rounds,
                         verify=True)
    rp = route_pod(topo, cfg, device=device)
    out["at_s"] = round(rp.timings["at_s"], 3)
    out["n_allowed_turns"] = len(rp.at.allowed)
    out["select_s"] = round(rp.timings["select_s"], 3)
    out["l_max"] = rp.l_max
    out["avg_hops"] = round(rp.avg_hops, 4)
    out["unreachable"] = rp.unreachable
    out["load_lower_bound"] = float(R.load_lower_bound(topo,
                                                       device=device))
    tab = rp.tables
    out["vcalloc_tables_s"] = round(rp.timings["vc_s"], 3)
    out["vc_greedy_dead_ends"] = int(rp.vc_stats.get("greedy_dead_ends", 0))
    out["deadlock_free"] = bool(rp.deadlock_free)
    out["end_to_end_s"] = round(out["at_s"] + out["select_s"] +
                                out["vcalloc_tables_s"], 3)
    if saturation:
        sstats: dict = {}
        t0 = time.time()
        sat, _ = NS.saturation_point(tab, stats=sstats, device=device,
                                     **(sat_kwargs or {}))
        out["saturation"] = round(float(sat), 5)
        out["saturation_s"] = round(time.time() - t0, 3)
        out["sim_kernel"] = sstats.get("kernel", "csr")
        out["sim_array_bytes"] = int(sstats.get("array_bytes", 0))
    return out
