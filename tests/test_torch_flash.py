"""The port's flash-attention path against the JAX package's.

On the CPU the port's wrapper takes the plain torch version
``ref.flash_attention_ref`` (the CUDA kernel is held to the same plain
version on the card by chip_smoke.py). Held here: the plain version
agrees with the Pallas kernel (interpret mode) over the sweep of
``tests/test_kernels.py``, the non-causal case and a causal Sq < Skv
case, and with the JAX ``ref.flash_attention_ref`` where the two causal
alignments agree (Sq == Skv), ragged S = 100 included. Tolerances are
``test_kernels.py``'s: 2e-5 for float32, 2e-2 for bfloat16 (one bf16
rounding of an output of magnitude ~1 is up to 4e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as kfa, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, Hq, Hkv, Sq, Skv, hd, dtype, seed=0):
    """The same inputs for both packages: numpy normals, rounded to the
    working dtype once, as a JAX array and a torch tensor each."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, Hq, Sq, hd), (B, Hkv, Skv, hd), (B, Hkv, Skv, hd)):
        x = jnp.asarray(rng.standard_normal(shape, np.float32), dtype)
        t = torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, dtype))
        out.append((x, t))
    return out


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_pallas_kernel_sweep(S, hd, heads, dtype):
    Hq, Hkv = heads
    (jq, q), (jk, k), (jv, v) = _qkv(1, Hq, Hkv, S, S, hd, dtype)
    got = ref.flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, pallas_flash(jq, jk, jv, causal=True, interpret=True), dtype)


def test_flash_ref_matches_pallas_kernel_noncausal():
    (jq, q), (jk, k), (jv, v) = _qkv(2, 4, 2, 128, 256, 64, "float32")
    _close(ref.flash_attention_ref(q, k, v, causal=False),
           pallas_flash(jq, jk, jv, causal=False, interpret=True), "float32")


def test_flash_ref_causal_is_top_left_like_the_pallas_kernel():
    """Sq = 128 < Skv = 256: the Pallas kernel masks ``qpos >= kpos``
    from 0 (top-left); so does the port. The JAX ``ref`` aligns the mask
    bottom-right and disagrees (reference caveat R5)."""
    (jq, q), (jk, k), (jv, v) = _qkv(1, 4, 2, 128, 256, 64, "float32")
    got = ref.flash_attention_ref(q, k, v, causal=True)
    _close(got, pallas_flash(jq, jk, jv, causal=True, interpret=True),
           "float32")
    bottom_right = np.asarray(jref.flash_attention_ref(jq, jk, jv, True))
    assert np.abs(got.numpy() - bottom_right).max() > 0.1


@pytest.mark.parametrize("S", [100, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_ref_when_sq_equals_skv(S, dtype):
    (jq, q), (jk, k), (jv, v) = _qkv(2, 8, 2, S, S, 128, dtype, seed=3)
    _close(ref.flash_attention_ref(q, k, v, causal=True),
           jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


def test_flash_ref_reads_the_model_layout_in_place():
    """(B, S, H, hd) activations passed as transposed views give what the
    contiguous (B, H, S, hd) copies give."""
    (_, q), (_, k), (_, v) = _qkv(2, 4, 2, 100, 100, 64, "bfloat16", seed=5)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ref.flash_attention_ref(*views),
                               ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


def test_ops_flash_attention_on_cpu_is_the_plain_version():
    (_, q), (_, k), (_, v) = _qkv(1, 4, 2, 64, 64, 64, "float32", seed=1)
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


def test_kernel_wrapper_takes_only_cuda_tensors():
    (_, q), (_, k), (_, v) = _qkv(1, 4, 2, 64, 64, 64, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(q, k, v)
    assert kfa.launches == 0


def test_ops_flash_attention_raises_on_other_devices():
    q = torch.empty((1, 4, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no path"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("case, match", [
    (dict(hd=96), "head_dim"),
    (dict(Hkv=3), "multiple"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(kdtype=torch.float32), "dtype"),
    (dict(Skv=0), "range"),
    (dict(k_S=32), "agree"),
])
def test_kernel_input_checks(case, match):
    """What the kernel does not take raises before any launch."""
    hd, Hkv = case.get("hd", 64), case.get("Hkv", 2)
    dtype = case.get("dtype", torch.bfloat16)
    Skv = case.get("Skv", 16)
    q = torch.zeros((1, 4, 16, hd), dtype=dtype)
    k = torch.zeros((1, Hkv, Skv, hd), dtype=case.get("kdtype", dtype))
    v = torch.zeros((1, Hkv, case.get("k_S", Skv), hd), dtype=k.dtype)
    with pytest.raises(ValueError, match=match):
        kfa.check_inputs(q, k, v)


def test_kernel_input_checks_accept_the_serving_layout():
    x = torch.zeros((1, 100, 16, 128), dtype=torch.bfloat16)
    kv = torch.zeros((1, 100, 2, 128), dtype=torch.bfloat16)
    g = kfa.check_inputs(x.transpose(1, 2), kv.transpose(1, 2),
                         kv.transpose(1, 2))
    assert g == kfa.Geometry(B=1, Hq=16, Hkv=2, Sq=100, Skv=100, hd=128)
    strided = torch.zeros((1, 16, 100, 256), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kfa.check_inputs(strided, kv.transpose(1, 2), kv.transpose(1, 2))
