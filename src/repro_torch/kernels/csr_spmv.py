"""ctypes wrapper of the hand-written f64 CSR SpMV ``csrc/csr_spmv.cu``.

The library is built at first use by :func:`nvcc.build` and loaded with
ctypes. :func:`csr_spmv` launches it on PyTorch's current stream and
counts its launches in ``launches``. It sums each row in the order that
``ref.csr_spmv_ref`` sums it on the CPU, so the two agree bit for bit: a
row of at most ``SEGMENT`` entries left to right from 0.0; a longer row
in consecutive segments of ``SEGMENT`` entries, each summed left to right
from 0.0, and then the segment sums left to right from 0.0.

A :class:`Plan`, made once per CSR on the host by :func:`plan`, sorts the
rows into the kernel's four classes by length: a thread a row up to
``SHORT_MAX`` entries, eight lanes of a warp a row up to ``QUARTER_MAX``,
a warp a row up to ``SEGMENT``, a block a longer row. The classes change
who adds, never the order, so every class gives the same sums.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).parent / "csrc" / "csr_spmv.cu"

# the order of the sum: rows longer than this are summed in segments of
# this many entries (the kernel's source defines the same constant)
SEGMENT = 2048
# rows of at most SHORT_MAX entries go to one thread, up to QUARTER_MAX
# to eight lanes of a warp, up to SEGMENT to a warp, longer ones to a
# block; the classes never change the result
SHORT_MAX = 32
QUARTER_MAX = 256
WARPS = 16            # warps a block of the kernel has
PROBE_ITERS = 4096        # the probe's loop trips, 64 dependent adds each

launches = 0          # kernel launches since the last reset
captured = 0          # launches recorded into CUDA graphs, not run
build_seconds = None  # wall time of this process's nvcc run, if any
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Plan:
    """The rows of more than ``SHORT_MAX`` entries of one CSR in the
    kernel's grid order, long rows, then warp rows, then quarter-warp rows
    (``order``, int32 on the CSR's device), with the size of each class,
    the warp rows a block takes, and the CSR's rows and entries. The
    kernel finds the short rows itself, in a pass over all rows."""
    order: torch.Tensor
    n_long: int
    n_warp: int
    n_quarter: int
    warp_rows: int
    rows: int
    nnz: int

    @property
    def n_short(self) -> int:
        return self.rows - self.order.numel()


def plan(indptr: np.ndarray, device) -> Plan:
    """The kernel's plan for a CSR with host row offsets ``indptr`` on
    ``device``: each row of more than SHORT_MAX entries once, longest
    first (ties in row order), so that the longest start first and each
    block's warps get rows of like length; the warp rows spread over
    about one block an SM of a CUDA device (``WARPS`` a block on the
    CPU, where the plan is not read)."""
    lens = np.diff(np.asarray(indptr, np.int64))
    # class 0 long, 1 warp, 2 quarter-warp; the rest are short
    cls = np.where(lens <= SHORT_MAX, 3, np.where(
        lens <= QUARTER_MAX, 2, np.where(lens <= SEGMENT, 1, 0)))
    by_len = np.argsort(-lens, kind="stable").astype(np.int32)
    classes = [by_len[cls[by_len] == k] for k in range(3)]
    device = torch.device(device)
    warp_rows = WARPS
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        warp_rows = min(WARPS, max(1, -(-len(classes[1]) // sms)))
    return Plan(torch.as_tensor(np.concatenate(classes), device=device),
                len(classes[0]), len(classes[1]), len(classes[2]), warp_rows,
                len(lens), int(indptr[-1]) if len(indptr) else 0)


def load(source: Path, name: str) -> Tuple[ctypes.CDLL, Optional[float]]:
    """Build ``source`` as the library ``name`` and bind its entry points;
    returns the library and nvcc's seconds (``None`` if built before)."""
    so, secs = nvcc.build(source, name)
    lib = ctypes.CDLL(str(so))
    lib.csr_spmv_f64.argtypes = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P)
    lib.csr_spmv_f64.restype = _I
    lib.csr_spmv_probe.argtypes = (_I, _I, _P, _P, _I, _P)
    lib.csr_spmv_probe.restype = _I
    return lib, secs


def library() -> ctypes.CDLL:
    """Build (once per source version) and load this checkout's kernel."""
    global _lib, build_seconds
    if _lib is None:
        _lib, build_seconds = load(SOURCE, "csr_spmv")
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


def check_plan(p: Plan, indptr: torch.Tensor, indices: torch.Tensor,
               out: Optional[torch.Tensor], device: torch.device) -> None:
    """The plan was made for a CSR of this many rows and entries, on this
    device; ``out``, if given, is a contiguous float64 vector of one
    value per row there. Reads nothing from the device."""
    rows = indptr.numel() - 1
    o = p.order
    if o.dtype != torch.int32 or o.dim() != 1 or not o.is_contiguous() \
            or o.device != device:
        raise ValueError(f"csr_spmv plan must hold a contiguous 1-D int32 "
                         f"tensor on {device}, got {o.dtype} on {o.device}")
    if (p.rows, p.nnz) != (rows, indices.numel()) or \
            o.numel() != p.n_long + p.n_warp + p.n_quarter or \
            not 1 <= p.warp_rows <= WARPS or \
            min(p.n_long, p.n_warp, p.n_quarter, p.n_short) < 0:
        raise ValueError(f"csr_spmv plan of {p.rows} rows and {p.nnz} "
                         f"entries does not match a CSR of {rows} rows and "
                         f"{indices.numel()} entries")
    if out is not None and (out.dtype != torch.float64 or out.dim() != 1
                            or not out.is_contiguous()
                            or out.numel() != rows or out.device != device):
        raise ValueError(f"csr_spmv out must be a contiguous float64 vector "
                         f"of {rows} values on {device}, got {out.dtype} of "
                         f"shape {tuple(out.shape)} on {out.device}")


def run(indptr: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
        x: torch.Tensor, p: Plan, out: Optional[torch.Tensor] = None,
        lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the kernel (this checkout's, or ``lib``) on checked
    operands, uncounted; raises if the launch fails."""
    rows = indptr.numel() - 1
    if out is None:
        out = torch.empty(rows, dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = (lib or library()).csr_spmv_f64(
        indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
        x.data_ptr(), out.data_ptr(), p.order.data_ptr(), rows, p.n_long,
        p.n_warp, p.warp_rows, p.n_quarter, SHORT_MAX, x.device.index,
        stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv_f64 launch failed: CUDA error {rc}")
    return out


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor,
             vals: torch.Tensor, x: torch.Tensor, p: Optional[Plan] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum_e vals[e] * x[indices[e]] over row r's entries, in
    the segmented order, on the GPU, by the plan ``p`` (:func:`plan`).
    Writes into ``out`` when given. Equals ``ref.csr_spmv_ref`` bit for
    bit. A launch recorded into a CUDA graph counts in ``captured``, not
    in ``launches``: the graph's replays count theirs
    (:func:`count_replay`)."""
    global launches, captured
    ts = (indptr, indices, vals, x)
    if not all(t.is_cuda for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError("csr_spmv kernel needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    check(indptr, indices, vals, x)
    if p is None:
        raise ValueError("csr_spmv kernel needs the CSR's plan "
                         "(csr_spmv.plan)")
    check_plan(p, indptr, indices, out, x.device)
    out = run(indptr, indices, vals, x, p, out)
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def count_replay(n: int) -> None:
    """Count the ``n`` kernel launches that one replay of a CUDA graph
    runs (the launches its capture recorded in ``captured``)."""
    global launches
    launches += n


def probe() -> Dict[str, float]:
    """Latency of one dependent f64 add (``__dadd_rn``) on the current
    CUDA device, in SM clock cycles: one thread on each SM runs a chain
    of ``PROBE_ITERS * 64`` dependent adds, timed with ``clock64()`` and
    the nanosecond ``globaltimer``. Returns the median, least and largest
    cycles an add over the threads, and the median SM clock (MHz) that
    the two timers give during the chain."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spans = torch.zeros(2 * sms, dtype=torch.int64, device=dev)
    sink = torch.empty(sms, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().csr_spmv_probe(sms, PROBE_ITERS, spans.data_ptr(),
                                  sink.data_ptr(), dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv_probe launch failed: CUDA error {rc}")
    pairs = spans.view(sms, 2).tolist()
    lat = sorted(c / (PROBE_ITERS * 64) for c, _ in pairs)
    mhz = sorted(c / ns * 1e3 for c, ns in pairs if ns > 0)
    return dict(median=lat[len(lat) // 2], least=lat[0], largest=lat[-1],
                threads=len(lat),
                sm_mhz=mhz[len(mhz) // 2] if mhz else None)


def order_chain(longest: int) -> int:
    """The longest dependent chain of adds that the order allows in a row
    of ``longest`` entries: its longest segment, then its segment sums."""
    return min(longest, SEGMENT) + -(-longest // SEGMENT)
