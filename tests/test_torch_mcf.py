"""The port's MCF evaluator and small-graph synthesis against the JAX
reference (mirrors test_mcf_synthesis.py): identical metric-LP COO and
pair-class keys, the paper's Appendix C values and HiGHS optima within
1e-9 of the reference's, equal generators and equal directed syntheses.

Importing ``repro.core.lp`` switches JAX to x64 for the whole process
(ROADMAP caveat R3); both packages get explicit numpy arrays here.
"""
import numpy as np
import pytest

from repro.core import mcf as M, smallgraphs as SG, topology as T
from repro_torch.core import lp as PL, mcf as PM, smallgraphs as PG, \
    synthesis as PS, topology as PT

TOL = 1e-9     # HiGHS on identical LPs: equal in practice


def _same_lp(got, want):
    c, A, b, lo, hi, keys, _ = got
    rc, rA, rb, rlo, rhi, rkeys, _ = want
    assert A.shape == rA.shape
    for f in ("rows", "cols", "vals"):
        g, w = getattr(A, f), getattr(rA, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for g, w in ((c, rc), (b, rb), (lo, rlo), (hi, rhi), (keys, rkeys)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("spec,mcf,diam,hops", [
    ((4, 4, 8), 0.0078125, 8, 4.032), ((4, 8, 8), 0.00390625, 10, 5.020)])
def test_pt_appendix_c_values(spec, mcf, diam, hops):
    topo = PT.pt(spec)
    perms = PT.torus_translations(topo.pod)
    lam, res = PM.mcf_uniform(topo.edges(), topo.n, perms=perms,
                              prefer="highs")
    want, _ = M.mcf_uniform(T.pt(spec).edges(), topo.n, perms=perms,
                            prefer="highs")
    assert res.status == "optimal"
    assert abs(lam - want) <= TOL and abs(lam - mcf) < 1e-6
    d, h = PT.diameter_avg_hops(topo, device="cpu")
    assert (d, h) == T.diameter_avg_hops(T.pt(spec))
    assert d == diam and abs(h - hops) < 0.01


def test_pdtt_appendix_c_value():
    topo = PT.pdtt((4, 4, 8))
    perms = PT.torus_translations(topo.pod, twisted=True)
    lam, _ = PM.mcf_uniform(topo.edges(), topo.n, perms=perms,
                            prefer="highs")
    want, _ = M.mcf_uniform(T.pdtt((4, 4, 8)).edges(), topo.n, perms=perms,
                            prefer="highs")
    assert abs(lam - want) <= TOL and abs(lam - 0.01364) < 2e-5


def test_radix_is_six():
    for make in (PT.pt, PT.pdtt, lambda s: PT.random_topology(s, seed=3)):
        topo = make((4, 4, 8))
        deg = np.bincount(topo.edges().ravel(), minlength=topo.n)
        assert (deg == 6).all(), make


def test_symmetry_reduction_preserves_mcf():
    """Cube-translation-reduced LP == the torus-reduced one on PT 4x4x8
    (the port's metric LP is the reference's, test_metric_lp_identical)."""
    topo = PT.pt((4, 4, 8))
    lam_cube, _ = PM.mcf_uniform(topo.edges(), topo.n,
                                 perms=PT.cube_translations(topo.pod),
                                 prefer="highs")
    lam_torus, _ = PM.mcf_uniform(topo.edges(), topo.n,
                                  perms=PT.torus_translations(topo.pod),
                                  prefer="highs")
    assert abs(lam_cube - 0.0078125) < 1e-6
    assert abs(lam_cube - lam_torus) < 1e-8


def _random_graph(rng, n=8, m=14):
    edges = set()
    perm = rng.permutation(n)
    for i in range(1, n):
        edges.add(tuple(sorted((int(perm[i - 1]), int(perm[i])))))
    while len(edges) < m:
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.add(tuple(sorted((int(u), int(v)))))
    return np.array(sorted(edges))


def test_one_leg_equals_full_triangles():
    """Appendix A on random small graphs: the port's one-leg LP has the
    reference's optimum and the full triangle set's."""
    rng = np.random.default_rng(0)
    n = 8
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pidx = {p: i for i, p in enumerate(pairs)}
    for trial in range(3):
        edges = _random_graph(rng, n)
        lam, _ = PM.mcf_uniform(edges, n, perms=None, prefer="highs")
        want, _ = M.mcf_uniform(edges, n, perms=None, prefer="highs")
        assert abs(lam - want) <= TOL, trial
        rows, cols, vals, b = [0] * len(pairs), list(range(len(pairs))), \
            [-1.0] * len(pairs), [-1.0]
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    if len({i, j, k}) < 3:
                        continue
                    r = len(b)
                    rows += [r, r, r]
                    cols += [pidx[tuple(sorted(p))] for p in
                             ((i, j), (i, k), (k, j))]
                    vals += [1.0, -1.0, -1.0]
                    b.append(0.0)
        A = PL.COOMatrix.from_triplets(rows, cols, vals, (len(b), len(pairs)))
        c = np.zeros(len(pairs))
        for u, v in edges:
            c[pidx[(int(u), int(v))]] += 1.0
        full = PL.solve_highs(c, A, np.array(b), np.zeros(len(pairs)),
                              np.ones(len(pairs)))
        assert abs(full.obj - lam) < 1e-6, trial


def test_paircanon_keys_equal():
    pod = PT.Pod((4, 4, 8))
    perms = PT.cube_translations(pod)
    pc = PM.PairCanon(perms, pod.n)
    ref = M.PairCanon(perms, pod.n)
    rng = np.random.default_rng(1)
    a = rng.integers(0, pod.n, 500)
    b = rng.integers(0, pod.n, 500)
    k0 = pc.key(a, b)
    assert np.array_equal(k0, ref.key(a, b))
    assert np.array_equal(pc.sources, ref.sources)
    for g in range(len(perms)):
        assert (pc.key(perms[g][a], perms[g][b]) == k0).all()
    assert (pc.key(b, a) == k0).all()
    d = PM.PairCanon(None, 16, directed=True)
    assert np.array_equal(d.key(a % 16, b % 16),
                          M.PairCanon(None, 16, directed=True).key(
                              a % 16, b % 16))


@pytest.mark.parametrize("case", ["pt_cube", "pdtt_twisted", "weighted",
                                  "directed"])
def test_metric_lp_identical(case):
    if case == "directed":
        edges = SG.gen_kautz(12, 3)
        _same_lp(PM.build_metric_lp(edges, 12, directed=True),
                 M.build_metric_lp(edges, 12, directed=True))
        return
    make = PT.pdtt if case == "pdtt_twisted" else PT.pt
    spec = (4, 4, 8) if case == "pdtt_twisted" else (4, 4, 4)
    topo = make(spec)
    perms = PT.torus_translations(topo.pod, twisted=True) \
        if case == "pdtt_twisted" else PT.cube_translations(topo.pod)
    pw = None
    if case == "weighted":
        def pw(a, b):
            return 1.0 + ((np.asarray(a) // 16) == (np.asarray(b) // 16))
    _same_lp(PM.build_metric_lp(topo.edges(), topo.n, perms,
                                pair_weight=pw),
             M.build_metric_lp(topo.edges(), topo.n, perms,
                               pair_weight=pw))


def test_duality_fixed_pt_topology():
    """TONS dual LP with m fixed to the PT matching == exact MCF(PT)."""
    pod = PT.Pod((4, 4, 8))
    lp = PS.build_synthesis_lp(pod, symmetric=True)
    pt_edges = set((u, v) for u, v, _ in PT.pt_optical(pod))
    lo, hi = lp.lo.copy(), lp.hi.copy()
    for oi, members in enumerate(lp.orbit_members):
        is_pt = all((u, v) in pt_edges for (u, v, _) in members)
        lo[lp.m_slice][oi] = hi[lp.m_slice][oi] = 1.0 if is_pt else 0.0
    res = PL.solve_highs(lp.c, lp.A, lp.b, lo, hi, method="highs-ipm")
    assert abs(-res.obj - 0.0078125) < 1e-4


def test_smallgraph_generators_equal():
    for r, m in ((2, 2), (3, 2), (4, 1)):
        assert np.array_equal(PG.kautz(r, m), SG.kautz(r, m))
    assert PG.kautz_sizes(4, 500) == SG.kautz_sizes(4, 500)
    for n, r in ((10, 4), (33, 3)):
        assert np.array_equal(PG.gen_kautz(n, r), SG.gen_kautz(n, r))
    for seed in (0, 5):
        assert np.array_equal(PG.xpander(20, 4, seed),
                              SG.xpander(20, 4, seed))
        assert np.array_equal(PG.jellyfish(20, 4, seed),
                              SG.jellyfish(20, 4, seed))
    assert PG.xpander(21, 4) is None and SG.xpander(21, 4) is None
    gk = PG.gen_kautz(10, 4)
    assert abs(PG.directed_mcf(gk, 10) - SG.directed_mcf(gk, 10)) <= TOL


def test_directed_synthesis_equal():
    """Fig. 1's directed synthesis gives the reference's edges (ties or
    beats GenKautz); the restart variant's tie-break noise too."""
    n, r = 10, 4
    edges, lams = PG.synthesize_directed(n, r, interval=1)
    want, wl = SG.synthesize_directed(n, r, interval=1)
    assert np.array_equal(edges, want)
    np.testing.assert_allclose(lams, wl, rtol=0, atol=TOL)
    assert PG.directed_mcf(edges, n) >= \
        PG.directed_mcf(PG.gen_kautz(n, r), n) - 1e-6
    e2, _ = PG.synthesize_directed(6, 5, interval=5, restarts=2, seed=1)
    w2, _ = SG.synthesize_directed(6, 5, interval=5, restarts=2, seed=1)
    assert np.array_equal(e2, w2) and len(e2) == 30
