"""ctypes wrapper of the hand-written (min,+) kernel ``csrc/minplus.cu``.

The library is built at first use by :func:`nvcc.build` and loaded with
ctypes. :func:`minplus` launches on PyTorch's current stream and counts
its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).parent / "csrc" / "minplus.cu"

launches = 0          # kernel launches since the last reset
build_seconds = None  # wall time of this process's nvcc run, if any
_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = nvcc.build(SOURCE, "minplus")
    lib = ctypes.CDLL(str(so))
    lib.minplus_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.minplus_f32.restype = ctypes.c_int
    _lib = lib
    return lib


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i, j] = min(1e9, min_k a[i, k] + b[k, j]) on the GPU.

    ``a`` (M, K) and ``b`` (K, N): contiguous float32 CUDA tensors on
    one device. Equals ``ref.minplus_ref`` whenever every output has a
    sum <= 1e9 (every hop matrix with a zero diagonal does).
    """
    global launches
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("minplus kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"minplus kernel takes float32, got {a.dtype} "
                         f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus shapes do not chain: {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus kernel needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    if not (0 < min(M, N, K) and max(M, N, K) < 2 ** 30):
        raise ValueError(f"minplus shape {(M, K, N)} out of range")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.minplus_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         M, N, K, a.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
