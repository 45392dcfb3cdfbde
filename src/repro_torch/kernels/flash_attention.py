"""ctypes wrapper of the hand-written flash-attention kernel
``csrc/flash_attention.cu``.

The library is built at first use by :func:`nvcc.build` and loaded with
ctypes. :func:`flash_attention` launches on PyTorch's current stream and
counts its launches in ``launches``. Its tensors keep the reference's
(B, H, S, hd) shape but may have any strides with ``hd`` contiguous, so
the model passes transposed views of its (B, S, H, hd) activations and
nothing is copied; the output takes the strides of ``q``. bf16 inputs
run the tensor-core kernel, fed by TMA, which also needs 16-byte
aligned bases and strides (:func:`check_inputs`); float32 inputs run the
CUDA-core kernel.

The kernel is bound to PyTorch as the custom op
``repro_torch::flash_attention`` (:data:`OP`), which
``kernels.ops.flash_attention`` calls: its CUDA part is
:func:`flash_attention` (the ctypes launch, counted), its CPU part
``ref.flash_attention_ref``, and its fake part an empty tensor of the
kernel's output layout, so that ``FakeTensorMode`` traces attention
(the dry run) without memory and without the plain version's score
matrix. A flop formula (:func:`flops`: 4 hd a visible (q, k) pair) is
registered with ``torch.utils.flop_counter``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import nvcc, ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128, 160, 256)
DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches since the last reset
build_seconds = None  # wall time of this process's nvcc run, if any
_lib = None


class Geometry(NamedTuple):
    B: int
    Hq: int
    Hkv: int
    Sq: int
    Skv: int
    hd: int


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Geometry:
    """The kernel's shape, type and layout rules; raises ValueError on
    anything it does not take. Device-free, so the CPU tests reach it."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-d q, k, v (B, H, S, hd)")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} are no multiple of kv heads {Hkv}")
    if min(B, Sq, Skv) == 0 or B * Hq > 65535 or max(Sq, Skv) >= 2 ** 31:
        raise ValueError(f"flash_attention shape {(B, Hq, Sq, Skv)} out of "
                         "range")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes one dtype of "
                         f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs head_dim contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma_layout(name, t)
    return Geometry(B, Hq, Hkv, Sq, Skv, hd)


def _check_tma_layout(name: str, t: torch.Tensor) -> None:
    """The bf16 kernel reads q, k and v by TMA, which needs a base on 16
    bytes and byte strides that are positive multiples of 16 (8
    elements). A dim of extent 1 is never stepped, so its stride is free."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention bf16 kernel needs {name} on a "
                         "16-byte boundary")
    for dim, what in enumerate(("batch", "head", "position")):
        st = t.stride(dim)
        if t.shape[dim] > 1 and (st <= 0 or st % 8):
            raise ValueError(
                f"flash_attention bf16 kernel needs {name}'s {what} stride "
                f"in bytes to be a positive multiple of 16, got {2 * st}")


def load(source: Path, name: str) -> Tuple[ctypes.CDLL, Optional[float]]:
    """Build ``source`` as library ``name`` (once per source version) and
    load it: the bound library and nvcc's seconds (``None`` when built
    before)."""
    so, seconds = nvcc.build(source, name)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib, seconds


def library() -> ctypes.CDLL:
    """Build (once per source version) and load this kernel's library."""
    global _lib, build_seconds
    if _lib is None:
        _lib, build_seconds = load(SOURCE, "flash_attention")
    return _lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Blocked GQA attention on the GPU, the CUDA counterpart of the
    Pallas ``flash_attention``: q (B, Hq, Sq, hd), k and v (B, Hkv, Skv,
    hd), causal mask ``qpos >= kpos`` counted from 0 for both (top-left).
    Float32 or bfloat16 on one CUDA device; the output has q's dtype."""
    global launches
    out = run(q, k, v, causal)
    launches += 1
    return out


def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the kernel of ``lib`` (from :func:`load`; this checkout's
    by default) on the current stream, uncounted: :func:`flash_attention`
    is the counted entry point."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or \
            not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    g = check_inputs(q, k, v)
    out = torch.empty_like(q)          # dense q keeps its strides
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    if lib is None:
        lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), g.hd, g.B, g.Hq, g.Hkv, g.Sq, g.Skv,
        strides, 1.0 / math.sqrt(g.hd), int(causal), q.device.index, stream)
    if rc < 0:
        raise RuntimeError(f"flash_attention tensor-map encode failed: "
                           f"CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (q, k) pairs one head of one sequence attends: with the
    top-left causal mask row i sees min(i + 1, Skv) keys."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + max(Sq - Skv, 0) * Skv


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def OP(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
       causal: bool) -> torch.Tensor:
    """The kernel as a custom op: on CUDA tensors :func:`flash_attention`
    (counted); on CPU tensors the plain version; on fake tensors an
    empty tensor laid out as the kernel's output."""
    return flash_attention(q, k, v, causal)


@OP.register_kernel("cpu")
def _op_cpu(q, k, v, causal):
    return ref.flash_attention_ref(q, k, v, causal)


@OP.register_fake
def _op_fake(q, k, v, causal):
    return torch.empty_like(q)          # the kernel's output: q's strides


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
          **kwargs) -> int:
    """4 hd flops a visible (q, k) pair of each head: q.k and P.V, a
    multiply and an add each (``PERF.md``'s bound)."""
    B, Hq, Sq, hd = q_shape
    return 4 * B * Hq * hd * visible_pairs(Sq, k_shape[2], causal)
