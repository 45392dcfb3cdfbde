"""Exact uniform-demand maximum concurrent flow via the LR metric LP.

For uniform all-pairs demand the LP dual of maximum concurrent flow is the
metric LP (Leighton-Rao):   lambda* = min  sum_{e in E} d_e
                            s.t.  sum_{i<j} d_ij >= 1,  d a semi-metric.
This is EXACT (the O(log n) gap applies to sparsest cut, not to MCF).
Conventions (calibrated against the paper's Appendix C): undirected edges of
capacity 1 shared by both directions, one demand per unordered pair; e.g.
PT 4x4x8 -> 1/128 = 0.00781.

One-leg reduction (paper 4.3.1 / Appendix A): triangle inequalities only for
(i,k) in E. Symmetry reduction (4.3.2): with an abelian automorphism group
(cube translations; full/twisted torus translations), variables collapse to
canonical pair classes and constraints to canonical sources.

Port of ``repro.core.mcf``: numpy on the host, unchanged; an LP that
:func:`repro_torch.core.lp.solve` sends to PDHG runs its chunk loop on
the ``device`` passed through ``kw`` (``None`` = CUDA).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.lp import COOMatrix, LPResult, solve


class PairCanon:
    """Deterministic pair -> canonical-class mapping under an abelian
    permutation group (rows of ``perms`` = node permutations, incl. id)."""

    def __init__(self, perms: np.ndarray, n: int, directed: bool = False):
        if perms is None:
            perms = np.arange(n, dtype=np.int32)[None, :]
        self.perms = np.asarray(perms, np.int64)
        self.n = n
        self.directed = directed
        # canonical rep + canonicalising group element for every node
        self.node_canon = self.perms.min(axis=0)            # (n,)
        self.node_g = self.perms.argmin(axis=0)             # (n,)
        self.sources = np.unique(self.node_canon)

    def key(self, a, b):
        """Canonical class key for pair arrays (a, b)."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        n = self.n
        k1 = self.node_canon[a] * n + self.perms[self.node_g[a], b]
        if self.directed:
            return k1
        k2 = self.node_canon[b] * n + self.perms[self.node_g[b], a]
        return np.minimum(k1, k2)


def _adjacency(edges: np.ndarray, n: int, directed: bool):
    out = [[] for _ in range(n)]
    for u, v in edges:
        out[int(u)].append(int(v))
        if not directed:
            out[int(v)].append(int(u))
    return out


def build_metric_lp(edges: np.ndarray, n: int,
                    perms: Optional[np.ndarray] = None,
                    directed: bool = False, pair_weight=None):
    """Returns (c, A, b, lo, hi, var_keys, canon).

    ``pair_weight(a_arr, b_arr) -> w`` generalises the normalisation to a
    weighted traffic matrix (beyond-paper: workload-shaped demand); weights
    must be invariant under ``perms`` when symmetry reduction is used."""
    pc = PairCanon(perms, n, directed)

    # all pair keys (chunked over sources to bound memory)
    all_nodes = np.arange(n, dtype=np.int64)
    uniq = set()
    edge_keys = pc.key(edges[:, 0], edges[:, 1])
    uniq.update(edge_keys.tolist())
    # normalisation weights need every pair's key count
    key_count: dict = {}
    for a0 in range(0, n, max(1, 4096 * 4096 // n)):
        a1 = min(n, a0 + max(1, 4096 * 4096 // n))
        aa = np.repeat(all_nodes[a0:a1], n)
        bb = np.tile(all_nodes, a1 - a0)
        mask = aa != bb
        if not directed:
            mask &= aa < bb
        kk = pc.key(aa[mask], bb[mask])
        if pair_weight is None:
            ks, cnt = np.unique(kk, return_counts=True)
        else:
            w = pair_weight(aa[mask], bb[mask])
            ks = np.unique(kk)
            cnt = np.zeros(len(ks))
            pos = np.searchsorted(ks, kk)
            np.add.at(cnt, pos, w)
        for k, c_ in zip(ks.tolist(), cnt.tolist()):
            key_count[k] = key_count.get(k, 0) + c_
    uniq.update(key_count.keys())

    var_keys = np.array(sorted(uniq), np.int64)
    vidx = {k: i for i, k in enumerate(var_keys.tolist())}
    nv = len(var_keys)

    # objective: edge-count per class (each undirected edge counted once)
    c = np.zeros(nv)
    ks, cnt = np.unique(edge_keys, return_counts=True)
    for k, c_ in zip(ks.tolist(), cnt.tolist()):
        c[vidx[k]] += c_

    rows, cols, vals = [], [], []
    b = []
    # normalisation: -sum w_N d <= -1
    for k, c_ in key_count.items():
        rows.append(0)
        cols.append(vidx[k])
        vals.append(-float(c_))
    b.append(-1.0)

    # triangle rows: canonical sources s, all j, k in N(s) -- vectorised
    adj = _adjacency(edges, n, directed)
    vmap = np.full(int(var_keys.max()) + 1, -1, np.int64)
    vmap[var_keys] = np.arange(nv)
    rows = [np.asarray(rows, np.int64)]
    cols = [np.asarray(cols, np.int64)]
    vals = [np.asarray(vals, np.float64)]
    r = 1
    for s in pc.sources.tolist():
        for k in adj[s]:
            js = np.arange(n, dtype=np.int64)
            js = js[(js != s) & (js != k)]
            m = len(js)
            kij = vmap[pc.key(np.full(m, s), js)]
            kik = vmap[pc.key(np.array([s]), np.array([k]))[0]]
            kkj = vmap[pc.key(np.full(m, k), js)]
            rr = np.arange(r, r + m, dtype=np.int64)
            rows.append(np.repeat(rr, 3))
            cols.append(np.stack([kij, np.full(m, kik), kkj], 1).ravel())
            vals.append(np.tile([1.0, -1.0, -1.0], m))
            r += m
    b = np.concatenate([np.asarray(b), np.zeros(r - 1)])
    A = COOMatrix.from_triplets(np.concatenate(rows), np.concatenate(cols),
                                np.concatenate(vals), (r, nv))
    lo = np.zeros(nv)
    hi = np.ones(nv)
    return c, A, np.array(b), lo, hi, var_keys, pc


def mcf_uniform(edges: np.ndarray, n: int,
                perms: Optional[np.ndarray] = None,
                directed: bool = False, prefer: str = "auto",
                pair_weight=None, **kw) -> Tuple[float, LPResult]:
    """Exact MCF of a fixed graph (uniform or weighted demand)."""
    c, A, b, lo, hi, _, _ = build_metric_lp(edges, n, perms, directed,
                                            pair_weight=pair_weight)
    res = solve(c, A, b, lo, hi, prefer=prefer, **kw)
    return float(res.obj), res


def mcf_topology(topo, perms: Optional[np.ndarray] = None,
                 prefer: str = "auto", **kw) -> float:
    from repro_torch.core.topology import cube_translations
    if perms is None:
        perms = cube_translations(topo.pod)
    lam, _ = mcf_uniform(topo.edges(), topo.n, perms=perms, prefer=prefer,
                         **kw)
    return lam


def mcf_upper_bound_basu(n: int, r: int = 6) -> float:
    """Basu et al. theoretical bound: lambda <= r / (n log_r n) (Fig. 3)."""
    return r / (n * (np.log(n) / np.log(r)))
