"""Fig. 1 reproduction: directed 4-radix topologies, literature baselines
vs TONS synthesis without TPU constraints.

Baselines: Kautz [48], GenKautz/Imase-Itoh [40], Xpander [85] (random lifts
of K_{r+1}), Jellyfish [77] (random regular). Synthesis: the same dualized
LR formulation with degree-<=r constraints on a directed edge set.
Conventions here: directed edges of capacity 1, one unit of demand per
ordered pair; Fig. 1's y-axis is n * MCF.

Port of ``repro.core.smallgraphs``: host numpy and HiGHS, unchanged.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lp import COOMatrix, solve_highs
from repro_torch.core.mcf import mcf_uniform


# ---------------------------------------------------------------------------
# Reference generators
# ---------------------------------------------------------------------------


def kautz(r: int, m: int) -> Optional[np.ndarray]:
    """Kautz digraph K(r, m): N = (r+1) r^m nodes, out/in degree r."""
    alpha = r + 1
    words = []
    for first in range(alpha):
        for rest in itertools.product(range(r), repeat=m):
            w = [first]
            for x in rest:
                # next symbol distinct from previous: offset encoding
                w.append((w[-1] + 1 + x) % alpha)
            words.append(tuple(w))
    idx = {w: i for i, w in enumerate(words)}
    edges = []
    for w in words:
        for nxt in range(alpha):
            if nxt == w[-1]:
                continue
            w2 = w[1:] + (nxt,)
            edges.append((idx[w], idx[w2]))
    return np.array(edges, np.int32)


def kautz_sizes(r: int, max_n: int) -> Dict[int, int]:
    out = {}
    m = 1
    while (r + 1) * r ** m <= max_n:
        out[(r + 1) * r ** m] = m
        m += 1
    return out


def gen_kautz(n: int, r: int) -> np.ndarray:
    """Imase-Itoh generalisation: i -> (-r*i - j) mod n, j = 1..r."""
    edges = []
    for i in range(n):
        for j in range(1, r + 1):
            v = (-r * i - j) % n
            if v != i:
                edges.append((i, v))
    return np.array(sorted(set(edges)), np.int32)


def xpander(n: int, r: int, seed: int = 0) -> Optional[np.ndarray]:
    """Random lift of K_{r+1}; needs n divisible by r+1. Undirected edges
    returned as both directed arcs."""
    base = r + 1
    if n % base:
        return None
    k = n // base
    rng = np.random.default_rng(seed)
    edges = []
    for u in range(base):
        for v in range(u + 1, base):
            perm = rng.permutation(k)
            for l in range(k):
                a = u * k + l
                b = v * k + int(perm[l])
                edges.append((a, b))
                edges.append((b, a))
    return np.array(edges, np.int32)


def jellyfish(n: int, r: int, seed: int = 0) -> Optional[np.ndarray]:
    """Random r-regular undirected graph (pairing model w/ retries)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        stubs = np.repeat(np.arange(n), r)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        if (pairs[:, 0] == pairs[:, 1]).any():
            continue
        und = {tuple(sorted(p)) for p in pairs.tolist()}
        if len(und) < len(pairs):
            continue
        edges = []
        for u, v in und:
            edges.append((u, v))
            edges.append((v, u))
        return np.array(edges, np.int32)
    return None


def directed_mcf(edges: np.ndarray, n: int, prefer="highs") -> float:
    lam, _ = mcf_uniform(edges, n, perms=None, directed=True, prefer=prefer)
    return lam


# ---------------------------------------------------------------------------
# Directed synthesis (TONS formulation, degree-constrained)
# ---------------------------------------------------------------------------


def build_directed_synthesis_lp(n: int, r: int):
    """Variables [lambda | m (n^2 ordered) | y (ordered triples)]."""
    pairs = [(a, b) for a in range(n) for b in range(n) if a != b]
    pidx = {p: i for i, p in enumerate(pairs)}
    n_m = len(pairs)
    trips = [(i, j, k) for i in range(n) for j in range(n) for k in range(n)
             if i != j and j != k and i != k]
    tidx = {t: i for i, t in enumerate(trips)}
    n_y = len(trips)
    m_off, y_off = 1, 1 + n_m
    n_var = y_off + n_y

    rows, cols, vals, b = [], [], [], []
    row = 0
    # C4 rows per ordered pair
    for (a, bb) in pairs:
        cols.append(0)
        vals.append(1.0)
        rows.append(row)
        for k in range(n):
            if k != a and k != bb:
                cols.append(y_off + tidx[(a, bb, k)])
                vals.append(-1.0)
                rows.append(row)
        for j in range(n):
            if j != a and j != bb:
                cols.append(y_off + tidx[(a, j, bb)])
                vals.append(1.0)
                rows.append(row)
        for i in range(n):
            if i != a and i != bb:
                cols.append(y_off + tidx[(i, a, bb)])
                vals.append(1.0)
                rows.append(row)
        cols.append(m_off + pidx[(a, bb)])
        vals.append(-1.0)
        rows.append(row)
        b.append(0.0)
        row += 1
    # degree constraints
    for a in range(n):
        for bb in range(n):
            if a != bb:
                cols.append(m_off + pidx[(a, bb)])
                vals.append(1.0)
                rows.append(row)
        b.append(float(r))
        row += 1
    for bb in range(n):
        for a in range(n):
            if a != bb:
                cols.append(m_off + pidx[(a, bb)])
                vals.append(1.0)
                rows.append(row)
        b.append(float(r))
        row += 1

    A = COOMatrix.from_triplets(rows, cols, vals, (row, n_var))
    c = np.zeros(n_var)
    c[0] = -1.0
    lo = np.zeros(n_var)
    hi = np.ones(n_var)
    return c, A, np.asarray(b), lo, hi, pairs, slice(m_off, m_off + n_m)


def synthesize_directed(n: int, r: int = 4, interval: Optional[int] = None,
                        verbose: bool = False, restarts: int = 1,
                        seed: int = 0) -> Tuple[np.ndarray, List[float]]:
    """Algorithm 3 for the unconstrained directed case (Fig. 1), with
    randomized greedy restarts (tiny tie-break noise on the fractional m)."""
    if restarts > 1:
        best = None
        for s in range(restarts):
            edges, lams = synthesize_directed(n, r, interval, verbose,
                                              restarts=1, seed=seed + s)
            lam = directed_mcf(edges, n)
            if best is None or lam > best[0]:
                best = (lam, edges, lams)
        return best[1], best[2]
    rng_noise = np.random.default_rng(seed)
    c, A, b, lo, hi, pairs, m_sl = build_directed_synthesis_lp(n, r)
    interval = interval or max(1, n // 8)
    out_deg = np.zeros(n, int)
    in_deg = np.zeros(n, int)
    fixed = np.zeros(len(pairs), bool)
    lambdas = []

    def feasible(i):
        a, bb = pairs[i]
        return (not fixed[i]) and hi[m_sl][i] > 0 and out_deg[a] < r \
            and in_deg[bb] < r

    while True:
        rem = [i for i in range(len(pairs)) if feasible(i)]
        if not rem:
            break
        res = solve_highs(c, A, b, lo, hi, method="highs-ipm")
        if res.status != "optimal":
            break
        lambdas.append(-res.obj)
        if verbose:
            print(f"  dsynth lambda={-res.obj:.5f} "
                  f"fixed={int(fixed.sum())}/{4 * n}")
        mv = res.x[m_sl].copy()
        if seed:
            mv = mv + rng_noise.normal(0, 2e-3, len(mv))
        mv[[not feasible(i) for i in range(len(pairs))]] = -np.inf
        picked = 0
        for i in np.argsort(-mv):
            if picked >= interval:
                break
            if feasible(int(i)) and mv[int(i)] > 0.0:
                fixed[int(i)] = True
                lo[m_sl][int(i)] = hi[m_sl][int(i)] = 1.0
                a, bb = pairs[int(i)]
                out_deg[a] += 1
                in_deg[bb] += 1
                for jj, (a2, b2) in enumerate(pairs):
                    if not fixed[jj] and (out_deg[a2] >= r or
                                          in_deg[b2] >= r):
                        hi[m_sl][jj] = 0.0
                picked += 1
        if picked == 0:
            break

    edges = np.array([pairs[i] for i in range(len(pairs)) if fixed[i]],
                     np.int32)
    return edges, lambdas
