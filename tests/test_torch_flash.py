"""The port's flash-attention path against the JAX package's.

On the CPU the port's wrapper takes the plain torch version
``ref.flash_attention_ref`` (the CUDA kernel is held to the same plain
version on the card by chip_smoke.py). Held here: the plain version
agrees with the Pallas kernel (interpret mode) over the sweep of
``tests/test_kernels.py``, the non-causal case and a causal Sq < Skv
case, and with the JAX ``ref.flash_attention_ref`` where the two causal
alignments agree (Sq == Skv), ragged S = 100 included; the same at the
head dims 160 and 256 (stablelm-12b's, gemma-7b's). Tolerances are
``test_kernels.py``'s: 2e-5 for float32, 2e-2 for bfloat16 (one bf16
rounding of an output of magnitude ~1 is up to 4e-3). The bf16 kernel's
own rounding points, rebuilt here in plain torch with its tiles (128
kv rows up to hd 128, 64 above; columns padded to a multiple of 64), are
held to the Pallas kernel at the same 2e-2.
"""
import re
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import bench_flash, flash_attention as kfa, ops, ref

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
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
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


def _tensor_core_rounding(q, k, v, causal, bk=128, hdp=None):
    """The bf16 tensor-core kernel's arithmetic in plain torch, tile by
    tile: bf16 products accumulated in f32, masked scores -1e30, the scale
    times log2(e) (f32) applied after the product inside exp2, an online
    softmax from m = -1e30 and l = 0, l summed from the f32 P, P rounded
    to bf16 for P.V with f32 accumulation, and acc / max(l, 1e-30) in
    q's dtype. ``hdp``: V's columns padded with zeros to that many, as in
    the kernel's shared memory (Q.K^T runs over the hd columns only); the
    output keeps the hd columns."""
    B, Hq, Sq, hd = q.shape
    Skv = k.shape[2]
    rep = Hq // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    vf = torch.nn.functional.pad(vf, (0, (hdp or hd) - hd))
    sl2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
           * torch.tensor(math.log2(math.e), dtype=torch.float32))
    m = torch.full((B, Hq, Sq, 1), ref.NEG_INF)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, hdp or hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, bk):
        s = q.float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            kpos = torch.arange(k0, min(k0 + bk, Skv))[None, :]
            s = s.masked_fill(kpos > qpos, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * sl2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l.clamp_min(1e-30))[..., :hd].to(q.dtype)


def _tile(hd):
    """(kv rows, columns) of the bf16 kernel's tiles at head dim ``hd``:
    ``Layout<HD>``'s BK and HDP."""
    return (128 if hd <= 128 else 64), -(-hd // 64) * 64


def test_tile_rule_is_the_kernels():
    """``_tile`` states the source's rule: kv tiles of 128 rows up to hd
    128 and 64 above, columns padded to a multiple of 64."""
    src = kfa.SOURCE.read_text()
    assert re.search(r"BK = HD <= 128 \? 128 : 64;", src)
    assert re.search(r"return \(HD \+ 63\) / 64 \* 64;", src)
    assert [_tile(hd) for hd in kfa.HEAD_DIMS] == \
        [(128, 64), (128, 128), (64, 192), (64, 256)]


_TC_SHAPES = ([(1, Hq, Hkv, S, S, hd, True) for S in (128, 256)
               for hd in (64, 128) for Hq, Hkv in ((4, 4), (4, 2), (8, 1))]
              + [(2, 4, 2, 128, 256, 64, False),
                 (1, 4, 2, 128, 256, 64, True)]
              # hd 160 (64 kv rows, V padded to 192 columns) and 256 (64
              # kv rows): causal MHA and GQA, non-causal and causal Sq < Skv
              + [(B, Hq, Hkv, Sq, Skv, hd, causal) for hd in (160, 256)
                 for B, Hq, Hkv, Sq, Skv, causal in (
                     (1, 4, 4, 128, 128, True), (1, 8, 2, 256, 256, True),
                     (2, 4, 2, 128, 256, False), (1, 4, 2, 128, 256, True))])


@pytest.mark.parametrize("B, Hq, Hkv, Sq, Skv, hd, causal", _TC_SHAPES)
def test_tensor_core_rounding_matches_pallas_kernel(B, Hq, Hkv, Sq, Skv, hd,
                                                    causal):
    """The bf16 kernel's rounding points, with its tiles at each head
    dim, fit the Pallas kernel's bf16 tolerance over the sweep, the
    non-causal and the Sq < Skv shapes."""
    (jq, q), (jk, k), (jv, v) = _qkv(B, Hq, Hkv, Sq, Skv, hd, "bfloat16",
                                     seed=7)
    bk, hdp = _tile(hd)
    got = _tensor_core_rounding(q, k, v, causal, bk=bk, hdp=hdp)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, pallas_flash(jq, jk, jv, causal=causal, interpret=True),
           "bfloat16")


def test_kernel_input_checks_bf16_needs_16_byte_strides():
    """TMA reads bf16 tensors: a position stride of 264 bytes, or a base
    off a 16-byte boundary, raises; float32 keeps the CUDA-core rules."""
    kv = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16)
    padded = torch.zeros((1, 4, 64, 132), dtype=torch.bfloat16)[..., :128]
    assert padded.stride(2) * 2 == 264
    with pytest.raises(ValueError, match="position stride"):
        kfa.check_inputs(padded, kv, kv)
    shifted = torch.zeros(4 * 64 * 128 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        kfa.check_inputs(shifted.view(1, 4, 64, 128), kv, kv)
    f32 = torch.zeros((1, 4, 64, 130))[..., :128]
    assert f32.stride(2) * 4 == 520
    shifted32 = torch.zeros(4 * 64 * 128 + 1)[1:].view(1, 4, 64, 128)
    for q in (f32, shifted32):
        assert kfa.check_inputs(q, kv.float(), kv.float()) == kfa.Geometry(
            B=1, Hq=4, Hkv=2, Sq=64, Skv=64, hd=128)


def test_kernel_input_checks_accept_the_serving_strides():
    """The model's (B, S, H, hd) views: 4096-byte position stride for q
    (16 heads of 128), 512 bytes for k and v (2 heads)."""
    x = torch.zeros((1, 891, 16, 128), dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros((1, 891, 2, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert x.stride(2) * 2 == 4096 and kv.stride(2) * 2 == 512
    assert kfa.check_inputs(x, kv, kv) == kfa.Geometry(
        B=1, Hq=16, Hkv=2, Sq=891, Skv=891, hd=128)


def test_bench_flash_needs_a_card(capsys):
    """The timing script exits 2 without a CUDA device and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would time it")
    assert bench_flash.main([str(kfa.SOURCE)]) == 2
    assert capsys.readouterr().out == ""


# --- head dims 160 and 256 -----------------------------------------------------


@pytest.mark.parametrize("hd", [160, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, Hq, Hkv, Sq, Skv, causal", [
    (2, 4, 2, 128, 256, False), (1, 4, 2, 128, 256, True)])
def test_flash_ref_matches_pallas_kernel_at_wide_heads(B, Hq, Hkv, Sq, Skv,
                                                        causal, hd, dtype):
    """The plain version against the Pallas kernel (interpret mode) at
    stablelm-12b's and gemma-7b's head dims, non-causal and causal with
    Sq < Skv (the sweep above takes them causal at Sq == Skv)."""
    (jq, q), (jk, k), (jv, v) = _qkv(B, Hq, Hkv, Sq, Skv, hd, dtype, seed=11)
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, pallas_flash(jq, jk, jv, causal=causal, interpret=True),
           dtype)


@pytest.mark.parametrize("hd", kfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_accept_every_head_dim(hd, dtype):
    """64, 128, 160 and 256 pass in the model's (B, S, H, hd) layout;
    96 still raises (``test_kernel_input_checks``)."""
    x = torch.zeros((1, 100, 32, hd), dtype=dtype).transpose(1, 2)
    kv = torch.zeros((1, 100, 8, hd), dtype=dtype).transpose(1, 2)
    assert kfa.check_inputs(x, kv, kv) == kfa.Geometry(
        B=1, Hq=32, Hkv=8, Sq=100, Skv=100, hd=hd)
    x96, kv96 = (torch.zeros((1, 100, H, 96), dtype=dtype).transpose(1, 2)
                 for H in (32, 8))
    with pytest.raises(ValueError, match="head_dim"):
        kfa.check_inputs(x96, kv96, kv96)
