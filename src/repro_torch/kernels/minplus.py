"""ctypes wrapper of the hand-written (min,+) kernel ``csrc/minplus.cu``.

The library is built at first use by :func:`nvcc.build` and loaded with
ctypes. It has two element paths: :func:`minplus` on float32 (any
input) and :func:`minplus_hops` on int16 hop counts, where ``HOP_INF``
means "no path" and one DPX instruction does the add and the min of two
output cells. Both launch on PyTorch's current stream and count their
launches, in ``launches`` and ``hop_launches``. :func:`probe` measures
the issue rates of the instructions the two paths are built from.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import HOP_INF

SOURCE = Path(__file__).parent / "csrc" / "minplus.cu"
PROBE_OPS = ("fadd", "fmin", "viaddmin_s32", "viaddmin_s16x2",
             "f32_add_min_pair")
# the probe: 256 threads a block, 4 blocks an SM (32 warps), each thread
# running 2048 iterations of 32 instructions over 8 independent chains
PROBE_THREADS, PROBE_BLOCKS_PER_SM = 256, 4
PROBE_ITERS, PROBE_OPS_PER_ITER = 2048, 32

launches = 0          # f32 kernel launches since the last reset
hop_launches = 0      # hop-path kernel launches since the last reset
build_seconds = None  # wall time of this process's nvcc run, if any
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = (_P, _P, _P, _I, _I, _I, _I, _P)


def load(source: Path, name: str):
    """Build ``source`` as library ``name`` and load it; returns the
    library and nvcc's seconds (``None`` if it was built before). Binds
    the entry points the source has: ``minplus_f32`` always, the hop
    path, the plan and the probe where present."""
    so, seconds = nvcc.build(source, name)
    lib = ctypes.CDLL(str(so))
    lib.minplus_f32.argtypes = _ENTRY
    lib.minplus_f32.restype = _I
    for fn, argtypes in (("minplus_hops", _ENTRY),
                         ("minplus_plan", (_I, _I, _I, _I, _I, _P)),
                         ("minplus_probe", (_I, _I, _I, _P, _P, _I, _P))):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    return lib, seconds


def library() -> ctypes.CDLL:
    """Build (once per source version) and load this checkout's kernel."""
    global _lib, build_seconds
    if _lib is None:
        _lib, build_seconds = load(SOURCE, "minplus")
    return _lib


def _check(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
           what: str):
    """Type, shape and layout rules shared by both paths; device-free,
    so the CPU tests reach them."""
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{what} kernel takes {dtype}, got {a.dtype} "
                         f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what} shapes do not chain: {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    if not (0 < min(M, N, K) and max(M, N, K) < 2 ** 30):
        raise ValueError(f"{what} shape {(M, K, N)} out of range")


def _check_cuda(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"{what} kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")


def run(a: torch.Tensor, b: torch.Tensor, lib=None,
        entry: str = "minplus_f32") -> torch.Tensor:
    """Launch ``entry`` of ``lib`` (default: this checkout's library) on
    checked operands, uncounted; raises if the launch fails."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib = lib or library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             M, N, K, a.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min(1e9, min_k a[i, k] + b[k, j]) on the GPU.

    ``a`` (M, K) and ``b`` (K, N): contiguous float32 CUDA tensors on
    one device. Equals ``ref.minplus_ref`` whenever every output has a
    sum <= 1e9 (every hop matrix with a zero diagonal does).
    """
    global launches
    _check_cuda(a, b, "minplus")
    _check(a, b, torch.float32, "minplus")
    out = run(a, b)
    launches += 1
    return out


def check_hops(a: torch.Tensor, b: torch.Tensor) -> None:
    """The hop path's rules on top of the shapes: int16 operands with
    every value in [0, HOP_INF] (one reduction per operand, one host read
    for both). Device-free, so the CPU tests reach it."""
    _check(a, b, torch.int16, "minplus_hops")
    named = (("a", a),) if a is b else (("a", a), ("b", b))
    ends = torch.stack([e for _, x in named for e in torch.aminmax(x)])
    ends = ends.tolist()
    for i, (name, _) in enumerate(named):
        lo, hi = ends[2 * i], ends[2 * i + 1]
        if lo < 0 or hi > HOP_INF:
            raise ValueError(f"minplus_hops {name} holds values outside "
                             f"[0, {HOP_INF}]: [{lo}, {hi}]")


def minplus_hops(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min(HOP_INF, min_k a[i, k] + b[k, j]) on the GPU, on
    int16 hop counts in [0, HOP_INF] (``HOP_INF`` = no path). Equals
    ``ref.minplus_hops_ref``."""
    global hop_launches
    _check_cuda(a, b, "minplus_hops")
    check_hops(a, b)
    out = run(a, b, entry="minplus_hops")
    hop_launches += 1
    return out


def plan(path: str, M: int, N: int, K: int) -> Dict[str, int]:
    """The kernel's launch plan for a shape on ``path`` ("f32" or "hops")
    on the current CUDA device: the tile (128 x 128 or 64 x 64 words),
    the tiles, the K splits (one thread block cluster per tile) and the
    blocks."""
    out = (ctypes.c_int * 4)()
    rc = library().minplus_plan(int(path == "hops"), M, N, K,
                                torch.cuda.current_device(),
                                ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"minplus_plan failed: CUDA error {rc}")
    return dict(tile="128x128" if out[0] else "64x64", tiles=out[1],
                splits=out[2], blocks=out[3])


def probe(op: str) -> Dict[str, float]:
    """Issue rate of one instruction (``PROBE_OPS``) on the current CUDA
    device, in instructions per SM per clock: ``PROBE_BLOCKS_PER_SM``
    blocks on every SM; per SM, the instructions its blocks ran over the
    span of its clock from the first block's start to the last one's
    end. Returns the median, least and largest over the SMs."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * PROBE_BLOCKS_PER_SM
    clocks = torch.zeros(blocks * 3, dtype=torch.int64, device=dev)
    sink = torch.empty(blocks * PROBE_THREADS, dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().minplus_probe(PROBE_OPS.index(op), blocks, PROBE_ITERS,
                                 clocks.data_ptr(), sink.data_ptr(),
                                 dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"minplus_probe launch failed: CUDA error {rc}")
    span: Dict[int, list] = {}
    for sm, t0, t1 in clocks.view(blocks, 3).tolist():
        s = span.setdefault(sm, [t0, t1, 0])
        s[0], s[1], s[2] = min(s[0], t0), max(s[1], t1), s[2] + 1
    per_block = PROBE_THREADS * PROBE_ITERS * PROBE_OPS_PER_ITER
    rates = sorted(nb * per_block / (t1 - t0) for t0, t1, nb in span.values())
    return dict(median=rates[len(rates) // 2], least=rates[0],
                largest=rates[-1], sms=len(rates))
