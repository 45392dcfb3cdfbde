"""ctypes wrapper of the hand-written f64 CSR SpMV ``csrc/csr_spmv.cu``.

The library is built at first use by :func:`nvcc.build` and loaded with
ctypes. :func:`csr_spmv` launches it on PyTorch's current stream and
counts its launches in ``launches``; it sums each row in CSR order, as
``ref.csr_spmv_ref`` does on the CPU, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).parent / "csrc" / "csr_spmv.cu"

launches = 0          # kernel launches since the last reset
build_seconds = None  # wall time of this process's nvcc run, if any
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (once per source version) and load this checkout's kernel."""
    global _lib, build_seconds
    if _lib is None:
        so, build_seconds = nvcc.build(SOURCE, "csr_spmv")
        lib = ctypes.CDLL(str(so))
        lib.csr_spmv_f64.argtypes = (_P, _P, _P, _P, _P, _I, _I, _P)
        lib.csr_spmv_f64.restype = _I
        _lib = lib
    return _lib


def check(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
          x: torch.Tensor) -> None:
    """Types, ranks and layout the kernel takes: int64 row offsets, int32
    column indices, float64 values and vector, all 1-D and contiguous.
    Device-free, so the CPU tests reach it. Column indices are trusted
    to lie in ``[0, len(x))``: ``lp.CSR.from_coo`` guarantees it, and a
    check would cost a pass over them and a host read per call."""
    want = ((indptr, torch.int64, "indptr"), (indices, torch.int32,
            "indices"), (vals, torch.float64, "vals"),
            (x, torch.float64, "x"))
    for t, dtype, name in want:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"csr_spmv {name} must be a contiguous 1-D "
                             f"{dtype} tensor, got {t.dtype} of shape "
                             f"{tuple(t.shape)}")
    if indices.numel() != vals.numel():
        raise ValueError(f"csr_spmv has {indices.numel()} indices and "
                         f"{vals.numel()} values")
    if not 0 < indptr.numel() <= 2 ** 31:
        raise ValueError(f"csr_spmv takes 0 to 2^31 - 1 rows, got "
                         f"{indptr.numel() - 1}")


def run(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked operands, uncounted; raises if the
    launch fails."""
    rows = indptr.numel() - 1
    out = torch.empty(rows, dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = library().csr_spmv_f64(indptr.data_ptr(), indices.data_ptr(),
                                vals.data_ptr(), x.data_ptr(),
                                out.data_ptr(), rows, x.device.index,
                                stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv_f64 launch failed: CUDA error {rc}")
    return out


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor,
             vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_e vals[e] * x[indices[e]] over row r's entries, in
    CSR order, on the GPU. Equals ``ref.csr_spmv_ref`` bit for bit."""
    global launches
    ts = (indptr, indices, vals, x)
    if not all(t.is_cuda for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError("csr_spmv kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    check(indptr, indices, vals, x)
    out = run(indptr, indices, vals, x)
    launches += 1
    return out
