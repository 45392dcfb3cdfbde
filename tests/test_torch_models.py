"""The port's dense LM against the JAX package's, on converted weights.

qwen2.5-3b at ``smoke_model()`` (2 layers, d_model 256, 4 query and 2 kv
heads of 64, vocab 512), reference weights from ``PRNGKey(0)`` carried
over by ``convert.params_from_jax``; on the CPU the port's attention
takes the flash kernel's plain version.

Tolerances, each with its reason:
- float32 inputs, where the point is the algorithm: 2e-5 (two f32
  summation orders over at most a few hundred terms).
- one bf16 layer: 2e-2 relative and absolute. Both sides round to bf16
  (relative step 2^-8 = 0.0039) at the same places except where the
  reference rounds more (``q * scale`` and P before P.V in bf16), so
  outputs differ by a few bf16 steps at most.
- model logits and caches (bf16, |logit| ~ 1): 4e-2 absolute and
  relative, ~10 bf16 steps of a unit logit, for two layers of such
  differences compounding (measured: 1.2e-2 on the logits, one bf16 step
  on the caches).
- prefill/decode against the full forward within the port: the
  reference's own tolerance for that check (``test_models.py``, rtol
  0.06, atol 0.15).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL, lm as jlm, model as JM
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import layers as PL, lm as plm, model as PM

ARCH = "qwen2.5-3b"
F32 = 2e-5
BF16_LAYER = 2e-2
BF16_MODEL = 4e-2


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, its params, port cfg, the port's converted LM)."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, pcfg, model


@pytest.fixture
def pair():
    return _pair(ARCH)


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and values."""
    return convert.tensor_from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(shape, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape, np.float32) * scale, dtype)


# --- configs ----------------------------------------------------------------


def test_configs_match_the_reference():
    assert preg.list_archs() == jreg.list_archs()
    for arch in jreg.list_archs():
        j, p = jreg.get_config(arch), preg.get_config(arch)
        assert dataclasses.asdict(p) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(p.smoke_model()) == \
            dataclasses.asdict(j.smoke_model()), arch


OTHER_ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
               "jamba-v0.1-52b", "seamless-m4t-medium"]


def _reference_leaves(jcfg, tree):
    """The reference tree's leaves under the port's names, layer by layer
    (an independent statement of the converter's mapping)."""
    out = {}
    for name, arr in convert._flatten(jax.tree.map(np.asarray, tree)).items():
        top, _, rest = name.partition(".")
        if top == "head_blocks":
            out[f"blocks.{rest}"] = arr
        elif top == "blocks" and jcfg.family == "hybrid":
            sub, _, leaf = rest.partition(".")
            for j in range(arr.shape[0]):
                i = j * jcfg.hybrid_period + int(sub[len("sub"):])
                out[f"blocks.{i}.{leaf}"] = arr[j]
        elif top in ("blocks", "enc_blocks", "dec_blocks"):
            first = jcfg.first_k_dense if top == "blocks" else 0
            for j in range(arr.shape[0]):
                out[f"{top}.{first + j}.{rest}"] = arr[j]
        else:
            out[name] = arr
    return out


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_families_init_cache_and_convert(arch):
    """The five archs beyond the dense family at ``smoke_model()``: the
    port's init has the reference's leaves, shapes and dtypes and its
    special leaves (f32 router; conv taps at scale 0.5; zero conv bias
    and gated-norm gain; ``dt_bias``, ``A_log`` and ``D`` by the
    reference's formulas); ``empty_cache`` holds a zero cache of every
    kind its layers use; and the converter carries the reference's tree
    over bit for bit."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    tree = JM.init_params(jcfg, jax.random.PRNGKey(0))
    want = _reference_leaves(jcfg, tree)
    model = PM.init_params(pcfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(want)
    for name, p in params.items():
        assert tuple(p.shape) == want[name].shape, name
        assert str(p.dtype).split(".")[-1] == str(want[name].dtype), name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("dt_bias", "A_log", "D"):
            np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        elif leaf in ("conv_b", "norm_w", "ln_x", "enc_ln_f"):
            assert not p.any(), name
    for name, p in params.items():
        if name.endswith("moe.router"):
            assert abs(float(p.std()) - pcfg.d_model ** -0.5) < 0.01, name
        if name.endswith("conv_w"):
            assert abs(float(p.float().std()) - 0.5) < 0.03, name

    S_enc = 6 if pcfg.family == "encdec" else None
    cache = PM.empty_cache(pcfg, 3, 8, S_enc=S_enc, device="cpu")
    kinds = {"encdec": ["ek", "ev", "k", "v"], "ssm": ["conv", "ssm"],
             "hybrid": ["conv", "k", "ssm", "v"]}.get(pcfg.family,
                                                       ["k", "v"])
    assert sorted(cache) == kinds
    assert all(not c.any() and c.shape[1] == 3 for c in cache.values())
    if "ek" in cache:
        assert cache["ek"].shape[2] == 6 and cache["k"].shape[2] == 8
    if "ssm" in cache:
        assert cache["ssm"].dtype == torch.float32
        assert cache["ssm"].shape[2:] == (pcfg.ssm_heads, pcfg.ssm_head_dim,
                                          pcfg.ssm_state)

    conv = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    for name, p in conv.named_parameters():
        arr = want[name]
        if p.dtype == torch.bfloat16:
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          arr.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(p.numpy(), arr, err_msg=name)


# --- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_match(dtype):
    x = _normal((2, 5, 256), dtype, seed=1, scale=3.0)
    w = _normal((256,), jnp.bfloat16, seed=2, scale=0.1)
    tol = F32 if dtype == jnp.float32 else BF16_LAYER
    _close(PL.rmsnorm(_t(x), _t(w)), JL.rmsnorm(x, w), tol)
    _close(PL.layernorm(_t(x), _t(w)), JL.layernorm(x, w), tol)


def test_rope_matches():
    x = _normal((2, 24, 4, 64), jnp.float32, seed=3)
    pos = jnp.arange(24) + 1000
    _close(PL.apply_rope(_t(x), _t(pos), 1e6),
           JL.apply_rope(x, pos, 1e6), F32)


@pytest.mark.parametrize("S", [24, 100])
def test_gqa_attention_matches_in_f32(S):
    """The port's prefill attention (the flash path) against the
    reference's blocked jnp ``gqa_attention`` at the model's layout."""
    q = _normal((2, S, 4, 64), jnp.float32, seed=4)
    k = _normal((2, S, 2, 64), jnp.float32, seed=5)
    v = _normal((2, S, 2, 64), jnp.float32, seed=6)
    _close(PL.gqa_attention(_t(q), _t(k), _t(v)),
           JL.gqa_attention(q, k, v, causal=True, block=16), F32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches(dtype):
    q = _normal((2, 1, 4, 64), dtype, seed=7)
    kc = _normal((2, 32, 2, 64), dtype, seed=8)
    vc = _normal((2, 32, 2, 64), dtype, seed=9)
    tol = F32 if dtype == jnp.float32 else BF16_LAYER
    _close(PL.decode_attention(_t(q), _t(kc), _t(vc), 19),
           JL.decode_attention(q, kc, vc, jnp.int32(19)), tol)


def test_attention_block_and_decode_match(pair):
    jcfg, params, _, model = pair
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    attn = model.blocks[0].attn
    x = _normal((2, 24, 256), jnp.bfloat16, seed=10)
    out, (k, v) = JL.attention_block(jp, x, jcfg, jnp.arange(24))
    with torch.no_grad():
        pout, (pk, pv) = attn(_t(x), torch.arange(24))
    _close(pout, out, BF16_LAYER)
    _close(pk, k, BF16_LAYER)
    _close(pv, v, BF16_LAYER)

    cache = {"k": jnp.pad(k, ((0, 0), (0, 8), (0, 0), (0, 0))),
             "v": jnp.pad(v, ((0, 0), (0, 8), (0, 0), (0, 0)))}
    kc, vc = _t(cache["k"]), _t(cache["v"])
    xd = _normal((2, 1, 256), jnp.bfloat16, seed=11)
    out, cache = JL.attention_decode(jp, xd, jcfg, cache, jnp.int32(24))
    with torch.no_grad():
        pout = attn.decode(_t(xd), kc, vc, 24, torch.tensor([24]))
    _close(pout, out, BF16_LAYER)
    _close(kc, cache["k"], BF16_LAYER)     # written in place at pos 24
    _close(vc, cache["v"], BF16_LAYER)


def test_glu_mlp_matches(pair):
    _, params, _, model = pair
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["mlp"])
    x = _normal((2, 24, 256), jnp.bfloat16, seed=12)
    with torch.no_grad():
        _close(model.blocks[0].mlp(_t(x)), JL.glu_mlp(jp, x, "silu"),
               BF16_LAYER)


# --- the model ------------------------------------------------------------------


def _tokens(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen1.5-32b", "gemma-7b",
                                  "stablelm-12b", "internvl2-2b"])
def test_forward_matches(arch):
    """Every dense arch at its smoke size: QKV bias, GeGLU with tied
    embeddings (gemma), LayerNorm with an untied head (stablelm), and
    patch embeddings added to the prefix (internvl2)."""
    jcfg, params, _, model = _pair(arch)
    toks = _tokens(jcfg)
    patches = _normal((2, jcfg.n_vision_tokens, jcfg.d_model),
                      jnp.bfloat16, seed=13) if jcfg.n_vision_tokens \
        else None
    want, _ = jlm.forward(jcfg, params, jnp.asarray(toks, jnp.int32),
                          patches)
    with torch.no_grad():
        got, aux = plm.forward(model, torch.as_tensor(toks),
                               None if patches is None else _t(patches))
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 24, jcfg.vocab)
    _close(got, want, BF16_MODEL)


def test_prefill_caches_and_decode_match(pair):
    """Prefill of 16 tokens into a 24-long cache, then 3 teacher-forced
    decode steps, against ``repro.models``."""
    jcfg, params, pcfg, model = pair
    toks = _tokens(jcfg, seed=1)
    t = 16
    jl, jc = JM.prefill_fn(jcfg, params,
                           {"tokens": jnp.asarray(toks[:, :t], jnp.int32)},
                           cache_len=24)
    with torch.no_grad():
        pl, pc = PM.prefill_fn(pcfg, model,
                               {"tokens": torch.as_tensor(toks[:, :t])},
                               cache_len=24)
    assert pl.shape == (2, 1, jcfg.vocab)
    _close(pl, jl, BF16_MODEL)
    for name in ("k", "v"):
        assert pc[name].shape == jc["blocks"][name].shape
        _close(pc[name], jc["blocks"][name], BF16_MODEL)
    for i in range(3):
        tok = toks[:, t + i:t + i + 1]
        jl, jc = JM.decode_fn(jcfg, params, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(t + i))
        with torch.no_grad():
            pl, pc = PM.decode_fn(pcfg, model, pc, torch.as_tensor(tok),
                                  t + i)
        _close(pl, jl, BF16_MODEL)
        for name in ("k", "v"):
            _close(pc[name], jc["blocks"][name], BF16_MODEL)


def test_prefill_decode_matches_forward(pair):
    """The port's own teacher-forcing consistency, as the reference's
    ``test_prefill_decode_matches_forward``: decode at position t after a
    prefill of t tokens reproduces the full forward's logits there."""
    _, _, pcfg, model = pair
    toks = torch.as_tensor(_tokens(pcfg, seed=2))
    t = 16
    with torch.no_grad():
        full = plm.forward(model, toks)[0].float()
        logits, caches = PM.prefill_fn(pcfg, model, {"tokens": toks[:, :t]},
                                       cache_len=24)
        torch.testing.assert_close(logits[:, 0].float(), full[:, t - 1],
                                   rtol=0.06, atol=0.15)
        for i in range(3):
            logits, caches = PM.decode_fn(pcfg, model, caches,
                                          toks[:, t + i:t + i + 1], t + i)
            torch.testing.assert_close(logits[:, 0].float(), full[:, t + i],
                                       rtol=0.06, atol=0.15)


# --- weights ------------------------------------------------------------------


def test_init_params_distributions_and_seed():
    cfg = preg.get_config(ARCH).smoke_model()
    a = PM.init_params(cfg, seed=0, device="cpu")
    b = PM.init_params(cfg, seed=0, device="cpu")
    c = PM.init_params(cfg, seed=1, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pa.dtype == torch.bfloat16
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.emb, c.emb)
    assert abs(float(a.emb.float().std()) - 0.02) < 0.001
    assert abs(float(a.blocks[1].mlp.w2.float().std())
               - cfg.d_ff ** -0.5) < 0.002
    for name, p in a.named_parameters():
        if name.rsplit(".", 1)[-1] in ("ln1", "ln2", "ln_f", "bq", "bk",
                                       "bv"):
            assert not p.any(), name


def test_convert_bf16_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
    arr = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf]]).astype(
        ml_dtypes.bfloat16)
    t = convert.tensor_from_numpy(arr)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))


def test_convert_rejects_a_mismatched_tree(pair):
    jcfg, params, pcfg, _ = pair
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"]["attn"]["bq"]
    with pytest.raises(KeyError, match="bq"):
        convert.params_from_jax(pcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["ln_f"] = np.zeros(3, ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="ln_f"):
        convert.params_from_jax(pcfg, tree, device="cpu")
