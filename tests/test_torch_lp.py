"""The port's LP stack against the JAX reference: the CSR operator and
its plain SpMV (bit-exact against numpy's in-order ``np.add.at``), the
Ruiz scaling and step size (bit-exact), PDHG on the 4^3 synthesis LP
(within 1e-9 of the reference, which sums in XLA's order: measured
drift 5e-14 relative in the objective), and the HiGHS dispatch.

Importing ``repro.core.lp`` switches JAX to x64 for the whole process
(ROADMAP caveat R3); every array handed to either package here is an
explicit float64 or integer numpy array.
"""
import numpy as np
import pytest
import torch

from repro.core import lp as L, mcf as M, synthesis as SY, \
    topology as T
from repro_torch.core import lp as PL, mcf as PM, synthesis as PS, \
    topology as PT
from repro_torch.kernels import csr_spmv as KS, ops, ref

TOL = 1e-9     # port against reference: XLA and torch sum in other orders


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """PDHG's CPU path is many small ops: intra-op threads only add
    overhead, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lp444():
    return (PS.build_synthesis_lp(PT.Pod((4, 4, 4))),
            SY.build_synthesis_lp(T.Pod((4, 4, 4))))


def _ragged(seed=0, m=300, n=200, nnz=4000):
    """A COO with unsorted rows, duplicate (row, col) entries, empty
    rows and values spread over many binades."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m - 40, nnz)          # rows m-40.. stay empty
    cols = rng.integers(0, n, nnz)
    rows[:500], cols[:500] = rows[500:1000], cols[500:1000]  # duplicates
    vals = rng.normal(size=nnz) * np.exp(rng.normal(size=nnz) * 4)
    x = rng.normal(size=n) * np.exp(rng.normal(size=n) * 4)
    return rows, cols, vals, x, (m, n)


def _add_at(rows, cols, vals, x, m):
    out = np.zeros(m)
    np.add.at(out, rows, vals * x[cols])
    return out


def test_csr_keeps_coo_order_and_duplicates():
    rows, cols, vals, _, (m, _) = _ragged()
    A = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    ip = A.indptr.numpy()
    assert A.indptr.dtype == torch.int64 and A.indices.dtype == torch.int32
    assert ip[0] == 0 and ip[-1] == len(vals)          # nothing coalesced
    assert (ip[-41:] == len(vals)).all()               # empty tail rows
    for r in (0, 7, m - 41):
        want = np.nonzero(rows == r)[0]                # COO order
        got = slice(ip[r], ip[r + 1])
        assert np.array_equal(A.indices.numpy()[got], cols[want])
        assert np.array_equal(A.vals.numpy()[got], vals[want])


@pytest.mark.parametrize("case", ["ragged", "A", "AT"])
def test_plain_spmv_equals_numpy_add_at_bitwise(case, lp444):
    if case == "ragged":
        rows, cols, vals, x, (m, _) = _ragged()
    else:
        A = lp444[0].A
        rng = np.random.default_rng(1)
        rows, cols = A.rows.astype(np.int64), A.cols.astype(np.int64)
        if case == "AT":
            rows, cols = cols, rows
        m = int(rows.max()) + 1
        x = rng.normal(size=int(cols.max()) + 1)
        vals = A.vals
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    got = csr @ torch.from_numpy(x)
    assert np.array_equal(got.numpy(), _add_at(rows, cols, vals, x, m))
    assert torch.equal(got, ref.csr_spmv_ref(csr.indptr, csr.indices,
                                             csr.vals, torch.from_numpy(x)))


def test_spmv_wrapper_checks():
    rows, cols, vals, x, (m, _) = _ragged()
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    xt = torch.from_numpy(x)
    KS.check(csr.indptr, csr.indices, csr.vals, xt)
    with pytest.raises(ValueError, match="int32"):
        KS.check(csr.indptr, csr.indices.long(), csr.vals, xt)
    with pytest.raises(ValueError, match="float64"):
        KS.check(csr.indptr, csr.indices, csr.vals.float(), xt)
    with pytest.raises(ValueError, match="indices"):
        KS.check(csr.indptr, csr.indices[:-1], csr.vals, xt)
    with pytest.raises(ValueError, match="CUDA"):
        KS.csr_spmv(csr.indptr, csr.indices, csr.vals, xt)
    with pytest.raises(ValueError, match="meta"):
        ops.csr_spmv(csr.indptr, csr.indices, csr.vals,
                     torch.empty(len(x), dtype=torch.float64,
                                 device="meta"))


def test_ruiz_scale_and_step_size_bitwise(lp444):
    A = lp444[0].A
    got = PL._ruiz_scale(A)
    want = L._ruiz_scale(lp444[1].A)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # the reference computes the step inline in solve_pdhg: the same
    # 60 power iterations from default_rng(0)
    import scipy.sparse as sp
    vals_s = want[0]
    As = sp.coo_matrix((vals_s, (A.rows, A.cols)), shape=A.shape).tocsr()
    v = np.random.default_rng(0).normal(size=A.shape[1])
    v /= np.linalg.norm(v)
    for _ in range(60):
        w = As.T @ (As @ v)
        v = w / np.linalg.norm(w)
    norm = float(np.sqrt(max(v @ (As.T @ (As @ v)), 1e-12)))
    assert PL._step_size(A, vals_s) == 0.9 / max(norm, 1e-9)


def test_solve_pdhg_matches_reference_444(lp444):
    plp, rlp = lp444
    got = PL.solve_pdhg(plp.c, plp.A, plp.b, plp.lo, plp.hi,
                        max_iters=2000, tol=2e-4, device="cpu")
    want = L.solve_pdhg(rlp.c, rlp.A, rlp.b, rlp.lo, rlp.hi,
                        max_iters=2000, tol=2e-4)
    assert (got.iters, got.status) == (want.iters, want.status)
    assert abs(got.obj - want.obj) <= TOL * abs(want.obj)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.y, want.y, rtol=0, atol=TOL)
    assert abs(got.rel_gap - want.rel_gap) <= TOL
    # the fixing loop consumes the descending order of the m values
    mg, mw = got.x[plp.m_slice], want.x[rlp.m_slice]
    assert np.array_equal(np.argsort(-mg, kind="stable"),
                          np.argsort(-mw, kind="stable"))


def test_solve_pdhg_warm_start_matches_reference(lp444):
    plp, rlp = lp444
    rng = np.random.default_rng(2)
    x0 = rng.random(plp.n_var)
    y0 = rng.random(plp.A.shape[0])
    got = PL.solve_pdhg(plp.c, plp.A, plp.b, plp.lo, plp.hi, max_iters=500,
                        x0=x0, y0=y0, device="cpu")
    want = L.solve_pdhg(rlp.c, rlp.A, rlp.b, rlp.lo, rlp.hi, max_iters=500,
                        x0=x0, y0=y0)
    assert got.iters == want.iters == 500
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.y, want.y, rtol=0, atol=TOL)


def test_solve_dispatch_and_highs_equal_reference():
    topo = T.pt((4, 4, 4))
    perms = T.torus_translations(topo.pod)
    lp_ref = M.build_metric_lp(topo.edges(), topo.n, perms)
    lp_port = PM.build_metric_lp(PT.pt((4, 4, 4)).edges(), 64, perms)
    c, A, b, lo, hi = lp_port[:5]
    rc, rA, rb, rlo, rhi = lp_ref[:5]
    hg = PL.solve_highs(c, A, b, lo, hi)
    hr = L.solve_highs(rc, rA, rb, rlo, rhi)
    assert hg.status == hr.status == "optimal"
    assert hg.obj == hr.obj
    assert np.array_equal(hg.x, hr.x) and np.array_equal(hg.y, hr.y)
    auto = PL.solve(c, A, b, lo, hi)                     # small: HiGHS
    assert auto.obj == hg.obj and auto.iters == 0
    pd = PL.solve(c, A, b, lo, hi, prefer="pdhg", max_iters=500,
                  device="cpu")
    pr = L.solve(rc, rA, rb, rlo, rhi, prefer="pdhg", max_iters=500)
    assert pd.iters == pr.iters == 500 and pd.status == pr.status
    assert abs(pd.obj - pr.obj) <= TOL * max(abs(pr.obj), 1.0)


def test_solve_pdhg_defaults_to_cuda(monkeypatch, lp444):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plp = lp444[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.solve_pdhg(plp.c, plp.A, plp.b, plp.lo, plp.hi, max_iters=250)
