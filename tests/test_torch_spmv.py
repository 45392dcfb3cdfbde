"""The CSR SpMV's summation order, its launch plan and the PDHG chunk as
a CUDA graph captures it, on the CPU.

The order: a row of at most ``SEGMENT`` entries is summed left to right
from 0.0 (numpy's in-order ``np.add.at``); a longer row in consecutive
segments of ``SEGMENT`` entries, each summed left to right from 0.0, then
the segment sums left to right from 0.0. The oracle here is that
segmented ``np.add.at``. The plan sorts rows into the kernel's three
classes and must never change the result, only who adds. The chunk's
static-buffer body (what ``solve_pdhg`` captures on CUDA) must equal the
functional chunk bit for bit.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.core import lp as PL, synthesis as PS, topology as PT
from repro_torch.kernels import csr_spmv as KS, ops, ref

SEG = KS.SEGMENT
# row lengths around every class boundary, and a row of 35 segments (more
# than the 16 warps of a block)
SEGMENT_ROWS = (0, 1, 31, 32, 33, 256, 257, 1000, SEG - 1, SEG, SEG + 1,
                2 * SEG, 2 * SEG + 1, 70000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lp444():
    return PS.build_synthesis_lp(PT.Pod((4, 4, 4)))


def _segments(seed=0, n=5000):
    """A COO whose rows have SEGMENT_ROWS entries, interleaved at random
    (so each row's CSR order is its COO order), values and vector over
    many binades."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(np.repeat(np.arange(len(SEGMENT_ROWS)),
                                     SEGMENT_ROWS))
    nnz = len(rows)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz) * np.exp(rng.normal(size=nnz) * 4)
    x = rng.normal(size=n) * np.exp(rng.normal(size=n) * 4)
    return rows, cols, vals, x, len(SEGMENT_ROWS)


def _segmented_add_at(rows, cols, vals, x, m):
    """The order by numpy: np.add.at into one slot per (row, segment),
    entries in COO order, then np.add.at of the slots into the rows."""
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    prods = vals[order] * x[cols[order]]
    start = np.searchsorted(r, np.arange(m))
    seg = (np.arange(len(r)) - start[r]) // SEG
    slot_rows, slot_of = np.unique(np.stack([r, seg], 1), axis=0,
                                   return_inverse=True)
    slots = np.zeros(len(slot_rows))
    np.add.at(slots, slot_of.ravel(), prods)
    out = np.zeros(m)
    np.add.at(out, slot_rows[:, 0], slots)
    return out


def _add_at(rows, cols, vals, x, m):
    out = np.zeros(m)
    np.add.at(out, rows, vals * x[cols])
    return out


def _lp_case(lp, transpose):
    rows, cols = lp.A.rows.astype(np.int64), lp.A.cols.astype(np.int64)
    if transpose:
        rows, cols = cols, rows
    x = np.random.default_rng(1).normal(size=int(cols.max()) + 1)
    return rows, cols, lp.A.vals, x, int(rows.max()) + 1


def test_segment_and_block_match_kernel_source():
    src = KS.SOURCE.read_text()
    got = re.findall(r"^#define SEGMENT (\d+)$", src, re.M)
    assert got == [str(KS.SEGMENT)]
    threads = re.findall(r"^constexpr int THREADS = (\d+);", src, re.M)
    assert [int(t) // 32 for t in threads] == [KS.WARPS]


@pytest.mark.parametrize("case", ["segments", "A", "AT"])
def test_plain_spmv_equals_segmented_add_at_bitwise(case, lp444):
    if case == "segments":
        rows, cols, vals, x, m = _segments()
    else:
        rows, cols, vals, x, m = _lp_case(lp444, case == "AT")
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    got = ref.csr_spmv_ref(csr.indptr, csr.indices, csr.vals,
                           torch.from_numpy(x))
    assert np.array_equal(got.numpy(),
                          _segmented_add_at(rows, cols, vals, x, m))


def test_short_rows_and_444_lp_keep_the_left_to_right_order(lp444):
    """Rows of at most SEGMENT entries sum as before the segments: one
    left-to-right sum from 0.0. Every row of the 4^3 LP is such a row, so
    its products are unchanged."""
    rows, cols, vals, x, m = _segments()
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    got = (csr @ torch.from_numpy(x)).numpy()
    flat = _add_at(rows, cols, vals, x, m)
    short = np.array(SEGMENT_ROWS) <= SEG
    assert np.array_equal(got[short], flat[short])
    for transpose in (False, True):
        rows, cols, vals, x, m = _lp_case(lp444, transpose)
        csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
        assert int(csr.indptr.diff().max()) <= SEG
        assert np.array_equal((csr @ torch.from_numpy(x)).numpy(),
                              _add_at(rows, cols, vals, x, m))


def test_plan_classes_every_row_once():
    rows, cols, vals, _, m = _segments()
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    p = csr.plan
    lens = np.array(SEGMENT_ROWS)
    order = p.order.numpy()
    assert p.order.dtype == torch.int32 and p.rows == m
    assert p.nnz == len(vals) == int(csr.indptr[-1])
    assert p.warp_rows == KS.WARPS
    # the plan holds every row over SHORT_MAX once; the kernel's short
    # pass takes the others
    short = np.nonzero(lens <= KS.SHORT_MAX)[0]
    assert np.array_equal(np.sort(np.concatenate([order, short])),
                          np.arange(m))
    ends = np.cumsum([0, p.n_long, p.n_warp, p.n_quarter])
    long_, warp, quarter = (order[a:b] for a, b in zip(ends[:-1], ends[1:]))
    assert ends[-1] == len(order) and p.n_short == len(short)
    # longest first
    assert list(lens[long_]) == [70000, 2 * SEG + 1, 2 * SEG, SEG + 1]
    assert list(lens[warp]) == [SEG, SEG - 1, 1000, KS.QUARTER_MAX + 1]
    assert list(lens[quarter]) == [KS.QUARTER_MAX, KS.SHORT_MAX + 1]
    assert list(lens[short]) == [0, 1, 31, KS.SHORT_MAX]
    again = KS.plan(csr.indptr.numpy(), "cpu")
    assert again.order.dtype == torch.int32
    assert torch.equal(again.order, p.order)
    assert (again.n_long, again.n_warp, again.n_quarter, again.nnz) == \
        (p.n_long, p.n_warp, p.n_quarter, p.nnz)
    empty = KS.plan(np.zeros(1, np.int64), "cpu")
    assert (empty.rows, empty.n_long, empty.n_warp, empty.n_quarter,
            empty.n_short, empty.nnz) == (0, 0, 0, 0, 0, 0)


def test_order_chain():
    assert [KS.order_chain(n) for n in (0, 578, SEG, SEG + 1, 8256,
                                        16576)] == \
        [0, 579, SEG + 1, SEG + 2, 2053, 2057]


def test_wrapper_checks_plan_and_out():
    rows, cols, vals, x, m = _segments()
    csr = PL.CSR.from_coo(rows, cols, vals, m, "cpu")
    cpu = torch.device("cpu")
    KS.check_plan(csr.plan, csr.indptr, csr.indices, None, cpu)
    KS.check_plan(csr.plan, csr.indptr, csr.indices,
                  torch.empty(m, dtype=torch.float64), cpu)
    other = PL.CSR.from_coo(rows[:-5], cols[:-5], vals[:-5], m, "cpu")
    fewer = PL.CSR.from_coo(rows, cols, vals, m + 1, "cpu")
    for p in (other.plan, fewer.plan):
        with pytest.raises(ValueError, match="plan"):
            KS.check_plan(p, csr.indptr, csr.indices, None, cpu)
    with pytest.raises(ValueError, match="plan"):
        KS.check_plan(dataclasses.replace(csr.plan,
                                          order=csr.plan.order.long()),
                      csr.indptr, csr.indices, None, cpu)
    with pytest.raises(ValueError, match="plan"):
        KS.check_plan(csr.plan, csr.indptr, csr.indices, None,
                      torch.device("meta"))
    for warp_rows in (0, KS.WARPS + 1):
        with pytest.raises(ValueError, match="plan"):
            KS.check_plan(dataclasses.replace(csr.plan, warp_rows=warp_rows),
                          csr.indptr, csr.indices, None, cpu)
    for out in (torch.empty(m, dtype=torch.float32),
                torch.empty(m + 1, dtype=torch.float64),
                torch.empty(m, dtype=torch.float64, device="meta")):
        with pytest.raises(ValueError, match="out"):
            KS.check_plan(csr.plan, csr.indptr, csr.indices, out, cpu)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA"):
        KS.csr_spmv(csr.indptr, csr.indices, csr.vals, xt, csr.plan)
    out = torch.full((m,), 7.0, dtype=torch.float64)
    got = ops.csr_spmv(csr.indptr, csr.indices, csr.vals, xt, csr.plan, out)
    assert got is out and torch.equal(out, csr @ xt)
    assert torch.equal(csr.mv(xt), csr @ xt)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_static_chunk_equals_functional_chunk_444(start, lp444):
    """The body solve_pdhg captures on CUDA, run eagerly, equals the
    functional chunk bit for bit, twice over (as a restart runs it)."""
    c, A, b, lo, hi = lp444.c, lp444.A, lp444.b, lp444.lo, lp444.hi
    vals_s, dr, dc, tau, cs, bs, los, his = PL._scale(
        *(np.asarray(v, np.float64) if i != 1 else v
          for i, v in enumerate((c, A, b, lo, hi))))
    Ad, ATd = PL._operators(A, vals_s, "cpu")
    cj, bj, loj, hij = (torch.from_numpy(np.ascontiguousarray(v))
                        for v in (cs, bs, los, his))
    rng = np.random.default_rng(3)
    if start == "cold":
        x0, y0 = np.clip(np.zeros(A.shape[1]), los, his), \
            np.zeros(A.shape[0])
    else:
        x0 = np.clip(rng.random(A.shape[1]), los, his)
        y0 = rng.random(A.shape[0])
    xj, yj = torch.from_numpy(x0), torch.from_numpy(y0)
    inner = 125                                  # odd: ends in x[1]
    chunk = PL._Chunk(Ad, ATd, cj, bj, loj, hij, tau, tau, inner)
    for _ in range(2):
        want = PL._pdhg_chunk(Ad, ATd, cj, bj, loj, hij, xj, yj, tau, tau,
                              inner)
        got = [t.clone() for t in chunk.run(xj, yj)]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        xj, yj = want[2], want[3]                # restart elsewhere
    assert chunk.graph is None


def test_bench_spmv_needs_a_card(monkeypatch, capsys):
    from repro_torch.kernels import bench_spmv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_spmv.main([str(KS.SOURCE)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
