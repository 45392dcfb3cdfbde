"""Time the f64 CSR SpMV kernel built from two sources, in turns, and the
PDHG chunk eager against its CUDA graph.

    python3 -m repro_torch.kernels.bench_spmv OTHER.cu

Builds this checkout's ``csrc/csr_spmv.cu`` and ``OTHER.cu`` (a source with
the ``csr_spmv_f64`` entry point, for example an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory) and times both
on one card on the PDHG loop's two products, A·x and Aᵀ·y of the
Ruiz-scaled synthesis LP at 4x8x8 and 8x8x8, in the order other, this,
this, other, with torch.sparse's CSR mv beside them (its device time is
that of every kernel a call launches), and this kernel on
the rows of each class of its plan alone (where its time goes). A source
without
this one's plan (it has no ``csr_spmv_probe``) is launched with the
one-thread-a-row signature ``(indptr, indices, vals, x, out, rows,
device, stream)``. Each time is given twice: CUDA events over
back-to-back bare launches (host dispatch included) and the kernel's own
device time from a profiler trace.

Then one 250-iteration PDHG chunk on the 4x8x8 LP: the functional eager
loop (``lp._pdhg_chunk``), the static-buffer body run eagerly, and the
body's CUDA graph replayed, in ms per iteration, the device time by
kernel of one replay from a profiler trace, and one restart's host work
(the copies to the host and the residuals, on the host's clock). Prints the card's name and
power limit first, then one JSON line per result. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import lp as PL, synthesis as PS, topology as PT
from repro_torch.kernels import csr_spmv as KS, nvcc
from repro_torch.kernels.timing import cuda_ms, device_ms

DIMS = ((4, 8, 8), (8, 8, 8))
REPS = 100


def load_other(path: Path):
    """The other source's library and a launcher of its kernel."""
    so, _ = nvcc.build(path, "csr_spmv_other")
    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "csr_spmv_probe"):
        return KS.load(path, "csr_spmv_other")[0], None
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.csr_spmv_f64.argtypes = (P, P, P, P, P, I, I, P)
    lib.csr_spmv_f64.restype = I

    def launch(a, x):
        rows = a.indptr.numel() - 1
        out = torch.empty(rows, dtype=torch.float64, device=x.device)
        rc = lib.csr_spmv_f64(
            a.indptr.data_ptr(), a.indices.data_ptr(), a.vals.data_ptr(),
            x.data_ptr(), out.data_ptr(), rows, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other csr_spmv_f64: CUDA error {rc}")
        return out
    return lib, launch


def operators():
    """A and Aᵀ of each synthesis LP on the card, each with an operand,
    and the Aᵀ and A of each class of its plan's rows alone."""
    rng = np.random.default_rng(0)
    out, parts = {}, {}
    for d in DIMS:
        lp = PS.build_synthesis_lp(PT.Pod(d))
        vals_s, _, _ = PL._ruiz_scale(lp.A)
        rows, cols = lp.A.rows.astype(np.int64), lp.A.cols.astype(np.int64)
        tag = "x".join(map(str, d))
        for name, (r, c, n_rows) in ((f"A x {tag}", (rows, cols,
                                                      lp.A.shape[0])),
                                     (f"AT y {tag}", (cols, rows,
                                                      lp.A.shape[1]))):
            op = PL.CSR.from_coo(r, c, vals_s, n_rows, "cuda")
            x = torch.as_tensor(rng.normal(size=int(c.max()) + 1),
                                device="cuda")
            out[name] = (op, x)
            p = op.plan
            ends = np.cumsum([0, p.n_long, p.n_warp, p.n_quarter])
            order = p.order.cpu().numpy()
            lens = np.bincount(r, minlength=n_rows)
            by_class = [order[a:b] for a, b in zip(ends[:-1], ends[1:])]
            by_class.append(np.nonzero(lens <= KS.SHORT_MAX)[0])
            for cls, ids in zip(("long", "warp", "quarter", "short"),
                                by_class):
                if len(ids) == 0:
                    continue
                new_id = np.full(n_rows, -1)
                new_id[ids] = np.arange(len(ids))
                keep = new_id[r] >= 0
                parts[f"{name} {cls}"] = (PL.CSR.from_coo(
                    new_id[r[keep]], c[keep], vals_s[keep], len(ids),
                    "cuda"), x)
    return out, parts


def time_spmv(label, lib, launch, ops_) -> None:
    for name, (a, x) in ops_.items():
        if launch is None:
            fn = lambda: KS.run(a.indptr, a.indices, a.vals, x,  # noqa: E731
                                a.plan, lib=lib)
        else:
            fn = lambda: launch(a, x)                          # noqa: E731
        equal = bool(torch.equal(fn(), KS.run(a.indptr, a.indices, a.vals,
                                              x, a.plan)))
        print(json.dumps(dict(
            source=label, operand=name, ms=cuda_ms(fn, REPS),
            **device_ms(fn, REPS, "csr_spmv"),
            equal_to_this=equal, reps=REPS)), flush=True)


def calls_device_ms(fn, reps: int):
    """Device time of every kernel that one of ``reps`` calls of ``fn``
    launches, from a profiler trace, and the kernels a call launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / reps / 1e3, len(spans) / reps


def time_library(ops_) -> None:
    for name, (a, x) in ops_.items():
        lib = torch.sparse_csr_tensor(a.indptr, a.indices.long(), a.vals,
                                      (a.indptr.numel() - 1, x.numel()))
        dev_ms, kernels = calls_device_ms(lambda: lib @ x, REPS)
        print(json.dumps(dict(source="torch.sparse", operand=name,
                              ms=cuda_ms(lambda: lib @ x, REPS),
                              device_ms=dev_ms, kernels_per_call=kernels)),
              flush=True)


def time_chunk(dims=(4, 8, 8), inner=250) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lp = PS.build_synthesis_lp(PT.Pod(dims))
    vals_s, dr, dc, tau, cs, bs, los, his = PL._scale(lp.c, lp.A, lp.b,
                                                      lp.lo, lp.hi)
    A, AT = PL._operators(lp.A, vals_s, "cuda")
    c, b, lo, hi, x, y = (
        torch.as_tensor(np.ascontiguousarray(v), device="cuda")
        for v in (cs, bs, los, his, np.clip(np.zeros(lp.A.shape[1]), los,
                                            his), np.zeros(lp.A.shape[0])))
    chunk = PL._Chunk(A, AT, c, b, lo, hi, tau, tau, inner)
    chunk.run(x, y)                                 # eager, then captured
    per_iter = {
        "functional_eager": cuda_ms(lambda: PL._pdhg_chunk(
            A, AT, c, b, lo, hi, x, y, tau, tau, inner), 3) / inner,
        "static_eager": cuda_ms(chunk.body, 3) / inner,
        "graph_replay": cuda_ms(chunk.graph.replay, 10) / inner}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk.graph.replay()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = e.name[:80]
            by_kernel[k] = by_kernel.get(k, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3
    # one restart of solve_pdhg on the host's clock: the four copies to the
    # host, then the residuals of the average and the last iterate
    A_sp = lp.A.to_scipy()
    c_h, b_h, lo_h, hi_h = (np.asarray(v, np.float64)
                            for v in (lp.c, lp.b, lp.lo, lp.hi))
    xl, yl, xa, ya = chunk.run(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [t.cpu().numpy() for t in (xa, ya, xl, yl)]
    t1 = time.perf_counter()
    for xh, yh in ((host[0] * dc, host[1] * dr), (host[2] * dc,
                                                  host[3] * dr)):
        PL._residuals(A_sp, c_h, b_h, lo_h, hi_h, xh, yh)
    t2 = time.perf_counter()
    c_h @ (host[0] * dc)
    t3 = time.perf_counter()
    restart = dict(copies_ms=(t1 - t0) * 1e3, residuals_ms=(t2 - t1) * 1e3,
                   one_c_dot_x_ms=(t3 - t2) * 1e3)
    print(json.dumps(dict(
        chunk=list(dims), inner=inner, ms_per_iter=per_iter,
        restart_host=restart,
        iters_per_s={k: 1e3 / v for k, v in per_iter.items()},
        replay_device_ms_by_kernel=dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])),
        replay_device_ms=sum(by_kernel.values()),
        replay_kernels=sum(1 for e in prof.events()
                           if e.device_type == DeviceType.CUDA))),
        flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_spmv: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    other = args.other.resolve()
    libs = {"this": (KS.library(), None), "other": load_other(other)}
    ops_, parts = operators()
    for label in ("other", "this", "this", "other"):
        time_spmv(label, *libs[label], ops_)
    time_library(ops_)
    time_spmv("this, one class", KS.library(), None, parts)
    time_chunk()
    return 0


if __name__ == "__main__":
    sys.exit(main())
