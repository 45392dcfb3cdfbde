"""First-order LP solver in torch (PDHG / PDLP-lite) + HiGHS oracle.

Problem form:   min  c.x   s.t.  A x <= b,  lo <= x <= hi.

Port of ``repro.core.lp``. ``COOMatrix``, ``LPResult``,
:func:`solve_highs`, the Ruiz equilibration, the power-iteration step
size, the residuals, restarts and stopping test stay host numpy/scipy,
as in the reference. The chunk loop of :func:`solve_pdhg` runs in
float64 on ``device``: every iteration is two CSR sparse products
(A·x and Aᵀ·y, :func:`repro_torch.kernels.ops.csr_spmv`: the
hand-written kernel on CUDA, its plain version on the CPU), two clips
and the running sums. The products sum each row in the COO's own order
(a stable sort, duplicates kept): a row of up to ``csr_spmv.SEGMENT``
entries left to right from 0.0, a longer one in ordered segments of
``SEGMENT``. So CUDA and the CPU give the same iterates bit for bit, run
after run. On CUDA the ``inner``-iteration chunk is captured once per
solve as a CUDA graph (:class:`_Chunk`) and replayed at every restart;
the CPU runs the same torch ops eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import csr_spmv as _spmv, ops

graph_replays = 0     # CUDA graph replays of a PDHG chunk since the reset


@dataclasses.dataclass
class COOMatrix:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]

    @staticmethod
    def from_triplets(rows, cols, vals, shape) -> "COOMatrix":
        return COOMatrix(np.asarray(rows, np.int32),
                         np.asarray(cols, np.int32),
                         np.asarray(vals, np.float64), shape)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix((self.vals, (self.rows, self.cols)),
                             shape=self.shape).tocsr()


@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    y: Optional[np.ndarray]
    obj: float
    status: str
    iters: int = 0
    rel_gap: float = 0.0
    primal_infeas: float = 0.0


@dataclasses.dataclass
class CSR:
    """A sparse operator as ``ops.csr_spmv`` takes it, on one device:
    int64 row offsets, int32 column indices, float64 values, and the
    kernel's plan of its rows (``csr_spmv.plan``)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor
    plan: _spmv.Plan

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows: int, device) -> "CSR":
        """Rows by a *stable* sort of the COO, so each row keeps its
        entries in COO order; duplicate (row, col) entries are kept, not
        summed, so every product adds them one by one as the reference's
        segment sums do."""
        order = np.argsort(rows, kind="stable")
        indptr = np.searchsorted(rows[order], np.arange(n_rows + 1))
        return CSR(torch.as_tensor(indptr.astype(np.int64), device=device),
                   torch.as_tensor(cols[order].astype(np.int32),
                                   device=device),
                   torch.as_tensor(np.asarray(vals, np.float64)[order],
                                   device=device),
                   _spmv.plan(indptr, device))

    def mv(self, v: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The product with ``v``, into ``out`` when given."""
        return ops.csr_spmv(self.indptr, self.indices, self.vals, v,
                            self.plan, out)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.mv(v)


def solve_highs(c, A: COOMatrix, b, lo, hi,
                method: str = "highs", **options) -> LPResult:
    """HiGHS oracle. Extra ``options`` are forwarded to scipy's linprog
    (e.g. ``ipm_optimality_tolerance=1e-4`` -- the synthesis fixing loop
    only consumes the *ordering* of the fractional m values, so loose
    IPM tolerances buy large-instance wall-clock at no quality cost)."""
    from scipy.optimize import linprog
    res = linprog(c, A_ub=A.to_scipy(), b_ub=b,
                  bounds=np.stack([lo, hi], axis=1), method=method,
                  options=options or None)
    y = None
    if res.status == 0 and hasattr(res, "ineqlin"):
        y = -np.asarray(res.ineqlin.marginals)
    return LPResult(res.x if res.x is not None else np.zeros_like(c),
                    y, float(res.fun) if res.fun is not None else np.nan,
                    "optimal" if res.status == 0 else f"status{res.status}")


def _ruiz_scale(A: COOMatrix, iters: int = 10):
    m, n = A.shape
    dr = np.ones(m)
    dc = np.ones(n)
    vals = A.vals.copy()
    for _ in range(iters):
        rmax = np.zeros(m)
        np.maximum.at(rmax, A.rows, np.abs(vals))
        rmax[rmax == 0] = 1.0
        vals /= np.sqrt(rmax)[A.rows]
        dr /= np.sqrt(rmax)
        cmax = np.zeros(n)
        np.maximum.at(cmax, A.cols, np.abs(vals))
        cmax[cmax == 0] = 1.0
        vals /= np.sqrt(cmax)[A.cols]
        dc /= np.sqrt(cmax)
    return vals, dr, dc


def _step_size(A: COOMatrix, vals_s: np.ndarray) -> float:
    """0.9 over the scaled operator's spectral norm (60 power
    iterations from ``default_rng(0)``), as the reference computes it."""
    import scipy.sparse as sp
    m, n = A.shape
    As = sp.coo_matrix((vals_s, (A.rows, A.cols)), shape=A.shape).tocsr()
    v = np.random.default_rng(0).normal(size=n)
    v /= np.linalg.norm(v)
    for _ in range(60):
        w = As.T @ (As @ v)
        nw = np.linalg.norm(w)
        if nw == 0:
            break
        v = w / nw
    norm = float(np.sqrt(max(v @ (As.T @ (As @ v)), 1e-12)))
    return 0.9 / max(norm, 1e-9)


def _pdhg_chunk(A: CSR, AT: CSR, c, b, lo, hi, x, y, tau: float,
                sigma: float, inner: int):
    """``inner`` PDHG iterations on the device; returns the last iterate
    and the averages. One torch op per step, in the reference's order,
    none of them fused (no ``alpha=``, no ``addcmul``), so no FMA
    contraction rounds differently on CUDA than on the CPU."""
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    for _ in range(inner):
        g = c + AT @ y
        x_new = torch.clamp(x - tau * g, lo, hi)
        r = A @ (2.0 * x_new - x) - b
        y_new = torch.clamp_min(y + sigma * r, 0.0)
        x, y = x_new, y_new
        xs = xs + x
        ys = ys + y
    return x, y, xs / inner, ys / inner


class _Chunk:
    """:func:`_pdhg_chunk` on static buffers, as a CUDA graph captures it:
    the same torch ops in the same order, each written with ``out=`` or
    in place into preallocated tensors, so that a replay allocates
    nothing. ``x`` and ``y`` are ping-pong pairs: iteration ``i`` reads
    ``x[i % 2]`` and writes ``x[1 - i % 2]``.

    :meth:`run` copies the start iterate into ``x[0]``, ``y[0]`` and runs
    the chunk: on the CPU eagerly (:meth:`body`); on CUDA eagerly the
    first time, on a side stream, which warms up every kernel, then
    captured once and replayed ever after. A capture or replay that
    fails raises."""

    def __init__(self, A: CSR, AT: CSR, c, b, lo, hi, tau: float,
                 sigma: float, inner: int):
        self.A, self.AT, self.c, self.b, self.lo, self.hi = \
            A, AT, c, b, lo, hi
        self.tau, self.sigma, self.inner = tau, sigma, inner
        n, m = c.numel(), b.numel()

        def buf(k):
            return torch.empty(k, dtype=torch.float64, device=c.device)
        self.x, self.y = (buf(n), buf(n)), (buf(m), buf(m))
        self.xs, self.ys, self.t_n, self.t_m = buf(n), buf(m), buf(n), buf(m)
        # the averages divide by a tensor on the device: CUDA multiplies
        # by the reciprocal of a host scalar, which rounds otherwise than
        # the CPU's division
        self.divisor = torch.tensor(float(inner), dtype=torch.float64,
                                    device=c.device)
        self.graph = None
        self.spmv_launches = 0    # csr_spmv launches one replay runs

    def step(self, i: int) -> None:
        """Iteration ``i`` of the chunk, op for op :func:`_pdhg_chunk`'s."""
        x, y = self.x[i % 2], self.y[i % 2]
        x_new, y_new = self.x[1 - i % 2], self.y[1 - i % 2]
        g, r = self.t_n, self.t_m
        self.AT.mv(y, out=g)                        # g = c + AT @ y
        torch.add(self.c, g, out=g)
        torch.mul(g, self.tau, out=g)               # x - tau * g
        torch.sub(x, g, out=g)
        torch.clamp(g, self.lo, self.hi, out=x_new)
        torch.mul(x_new, 2.0, out=g)                # r = A @ (2x' - x) - b
        torch.sub(g, x, out=g)
        self.A.mv(g, out=r)
        torch.sub(r, self.b, out=r)
        torch.mul(r, self.sigma, out=r)             # y + sigma * r
        torch.add(y, r, out=r)
        torch.clamp_min(r, 0.0, out=y_new)
        self.xs.add_(x_new)
        self.ys.add_(y_new)

    def body(self) -> None:
        """The whole chunk from ``x[0]``, ``y[0]``, with zeroed sums."""
        self.xs.zero_()
        self.ys.zero_()
        for i in range(self.inner):
            self.step(i)

    def run(self, x: torch.Tensor, y: torch.Tensor):
        """The chunk from ``(x, y)``: the last iterate (static buffers,
        valid until the next run) and the averages."""
        global graph_replays
        self.x[0].copy_(x)
        self.y[0].copy_(y)
        if self.c.device.type != "cuda":
            self.body()
        elif self.graph is not None:
            self.graph.replay()
            _spmv.count_replay(self.spmv_launches)
            graph_replays += 1
        else:
            main = torch.cuda.current_stream(self.c.device)
            side = torch.cuda.Stream(self.c.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.body()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            captured = _spmv.captured
            with torch.cuda.graph(graph):
                self.body()
            self.spmv_launches = _spmv.captured - captured
            self.graph = graph
        last = self.inner % 2
        return (self.x[last], self.y[last], self.xs / self.divisor,
                self.ys / self.divisor)


def _residuals(A_sp, c, b, lo, hi, x, y):
    ax = A_sp @ x
    pinf = np.linalg.norm(np.maximum(ax - b, 0.0)) / (1 + np.linalg.norm(b))
    pobj = float(c @ x)
    r = c + (A_sp.T @ y)
    dobj = float(-b @ y + np.sum(np.where(r > 0, lo * r, hi * r)))
    gap = abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj))
    return pobj, dobj, gap, pinf


def _scale(c, A: COOMatrix, b, lo, hi):
    """The Ruiz-scaled problem on the host: scaled values, the row and
    column scales, the step size and the scaled c, b, lo and hi."""
    vals_s, dr, dc = _ruiz_scale(A)
    # scaled problem: x = Dc xs, rows scaled by Dr:
    return (vals_s, dr, dc, _step_size(A, vals_s), c * dc, b * dr, lo / dc,
            hi / dc)


def _operators(A: COOMatrix, vals_s: np.ndarray, device):
    """The scaled A and Aᵀ as CSRs on ``device``."""
    rows = np.asarray(A.rows, np.int64)
    cols = np.asarray(A.cols, np.int64)
    m, n = A.shape
    return (CSR.from_coo(rows, cols, vals_s, m, device),
            CSR.from_coo(cols, rows, vals_s, n, device))


def solve_pdhg(c, A: COOMatrix, b, lo, hi, max_iters: int = 40000,
               tol: float = 1e-5, inner: int = 250,
               x0: Optional[np.ndarray] = None,
               y0: Optional[np.ndarray] = None,
               verbose: bool = False, device=None) -> LPResult:
    """The reference's PDHG with restarts; the chunk loop runs on
    ``device`` (``None`` = CUDA, which raises when no GPU is present):
    a CUDA graph of the chunk there, the eager loop on the CPU."""
    device = resolve_device(device)
    c = np.asarray(c, np.float64)
    b = np.asarray(b, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)

    vals_s, dr, dc, tau, cs, bs, los, his = _scale(c, A, b, lo, hi)
    sigma = tau
    A_sp = A.to_scipy()
    Ad, ATd = _operators(A, vals_s, device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                               device=device)

    cj, bj, loj, hij = dev(cs), dev(bs), dev(los), dev(his)
    if device.type == "cuda":
        chunk = _Chunk(Ad, ATd, cj, bj, loj, hij, tau, sigma, inner).run
    else:
        def chunk(xj, yj):
            return _pdhg_chunk(Ad, ATd, cj, bj, loj, hij, xj, yj, tau,
                               sigma, inner)

    x = np.clip(x0 / dc, los, his) if x0 is not None \
        else np.clip(np.zeros(A.shape[1]), los, his)
    y = (y0 / dr) if y0 is not None else np.zeros(A.shape[0])
    xj = dev(x)
    yj = dev(np.maximum(y, 0.0))

    best = None
    it = 0
    while it < max_iters:
        xj, yj, xavg, yavg = chunk(xj, yj)
        it += inner
        # evaluate averaged and current iterates in the original space
        x_avg_u = xavg.cpu().numpy() * dc
        y_avg_u = yavg.cpu().numpy() * dr
        x_cur_u = xj.cpu().numpy() * dc
        y_cur_u = yj.cpu().numpy() * dr
        for xu, yu, tag in ((x_avg_u, y_avg_u, "avg"),
                            (x_cur_u, y_cur_u, "cur")):
            pobj, dobj, gap, pinf = _residuals(A_sp, c, b, lo, hi, xu, yu)
            if best is None or (gap + pinf) < (best[2] + best[3]):
                best = (xu, yu, gap, pinf, pobj, tag)
        if verbose:
            print(f"  pdhg it={it} gap={best[2]:.2e} pinf={best[3]:.2e} "
                  f"obj={best[4]:.6g} ({best[5]})")
        if best[2] < tol and best[3] < tol:
            break
        # restart from the best candidate (rescaled)
        xj = dev(best[0] / dc)
        yj = dev(best[1] / dr)

    xu, yu, gap, pinf, pobj, _ = best
    status = "optimal" if (gap < tol and pinf < tol) else "max_iters"
    return LPResult(xu, yu, pobj, status, iters=it, rel_gap=gap,
                    primal_infeas=pinf)


def solve(c, A: COOMatrix, b, lo, hi, prefer: str = "auto",
          **kw) -> LPResult:
    """auto: HiGHS for small instances, PDHG otherwise (``kw``, including
    ``device``, goes to :func:`solve_pdhg`)."""
    small = A.shape[0] * A.shape[1] < 5e9 and len(A.vals) < 3e6 \
        and A.shape[1] < 200000
    if prefer == "highs" or (prefer == "auto" and small):
        try:
            res = solve_highs(c, A, b, lo, hi)
            if res.status == "optimal":
                return res
        except Exception:
            pass
    return solve_pdhg(c, A, b, lo, hi, **kw)
