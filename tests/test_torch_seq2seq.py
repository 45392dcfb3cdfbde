"""The port's encoder-decoder against the reference's ``seq2seq``.

seamless-m4t-medium at ``smoke_model()`` (2 encoder and 2 decoder layers,
d_model 256, 4 heads of 64, LayerNorm, GeGLU, vocab 512), reference
weights from ``PRNGKey(0)`` carried over by
``convert.params_from_jax``; frames and tokens from
``default_rng``. On the CPU both prefill attentions (the encoder's
non-causal self-attention and the decoder's cross attention) take the
flash kernel's plain version.

Tolerances: one bf16 layer 2e-2 relative and absolute, a few bf16 steps
(``test_torch_models.py``'s layer tolerance); the encoder's states,
logits and caches ``torch_parity.MODEL_TOL[ARCH]``, 6e-2 relative and
absolute (forward logits measured 0.066 from the reference's, 1.17 of
``test_torch_models.py``'s 4e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as R
from repro.configs import registry as jreg
from repro.models import layers as JL, model as JM, seq2seq as js2s
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import layers as PL, model as PM, seq2seq as ps2s

ARCH = "seamless-m4t-medium"
BF16_LAYER = 2e-2


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jreg.get_config(ARCH).smoke_model()
    pcfg = preg.get_config(ARCH).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, pcfg, model


@pytest.fixture
def pair():
    return _pair()


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, rtol=R.MODEL_TOL[ARCH][0],
           atol=R.MODEL_TOL[ARCH][1]):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _inputs(cfg, S_enc=24, S=24, seed=0):
    rng = np.random.default_rng(seed)
    frames = jnp.asarray(rng.standard_normal((2, S_enc, cfg.d_model)),
                         jnp.bfloat16)
    return frames, rng.integers(0, cfg.vocab, (2, S))


def test_encode_matches(pair):
    jcfg, params, _, model = pair
    frames, _ = _inputs(jcfg)
    with torch.no_grad():
        got = ps2s.encode(model, _t(frames))
    assert got.dtype == torch.bfloat16 and got.shape == frames.shape
    _close(got, js2s.encode(jcfg, params, frames))


def test_cross_attention_matches(pair):
    """One decoder layer's cross attention on the reference's encoder
    states: queries of 16 positions over 24 encoder positions (Sq != Skv,
    no mask), without RoPE."""
    jcfg, params, _, model = pair
    frames, _ = _inputs(jcfg)
    enc_x = js2s.encode(jcfg, params, frames)
    lp = jax.tree.map(lambda a: a[1], params["dec_blocks"])
    blk = model.dec_blocks[1]
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 16, jcfg.d_model)), jnp.bfloat16)
    ek, ev = js2s._enc_kv(lp, enc_x, jcfg)
    want = JL.cross_attention(lp["xattn"], x, (ek, ev), jcfg)
    with torch.no_grad():
        pek, pev = ps2s._enc_kv(blk, _t(enc_x), jcfg)
        got = PL.cross_attention(blk.xattn, _t(x), (pek, pev), jcfg)
    _close(pek, ek, BF16_LAYER, BF16_LAYER)
    _close(pev, ev, BF16_LAYER, BF16_LAYER)
    _close(got, want, BF16_LAYER, BF16_LAYER)


def test_forward_matches(pair):
    jcfg, params, _, model = pair
    frames, toks = _inputs(jcfg)
    want = js2s.forward(jcfg, params, frames, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = ps2s.forward(model, _t(frames), torch.as_tensor(toks))
    assert got.shape == (2, 24, jcfg.vocab)
    _close(got, want)


def test_prefill_caches_and_decode_match(pair):
    """24 frames and a prompt of 16 tokens into a 24-long cache, then 3
    teacher-forced decode steps: logits and all four caches."""
    jcfg, params, pcfg, model = pair
    frames, toks = _inputs(jcfg, seed=2)
    t = 16
    jl, jc = JM.prefill_fn(jcfg, params, {
        "frames": frames, "tokens": jnp.asarray(toks[:, :t], jnp.int32)},
        cache_len=24)
    with torch.no_grad():
        pl, pc = PM.prefill_fn(pcfg, model, {
            "frames": _t(frames), "tokens": torch.as_tensor(toks[:, :t])},
            cache_len=24)
    assert sorted(pc) == ["ek", "ev", "k", "v"]
    for step in range(4):
        if step:
            tok = toks[:, t + step - 1:t + step]
            jl, jc = JM.decode_fn(jcfg, params, jc,
                                  jnp.asarray(tok, jnp.int32),
                                  jnp.int32(t + step - 1))
            with torch.no_grad():
                pl, pc = PM.decode_fn(pcfg, model, pc,
                                      torch.as_tensor(tok), t + step - 1)
        assert pl.shape == (2, 1, jcfg.vocab)
        _close(pl, jl)
        for name in ("k", "v", "ek", "ev"):
            assert pc[name].shape == jc["dec_blocks"][name].shape
            _close(pc[name], jc["dec_blocks"][name])


def test_empty_cache_shapes():
    cfg = preg.get_config(ARCH).smoke_model()
    c = PM.empty_cache(cfg, 3, 32, S_enc=20, device="cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "k": (2, 3, 32, 4, 64), "v": (2, 3, 32, 4, 64),
        "ek": (2, 3, 20, 4, 64), "ev": (2, 3, 20, 4, 64)}
    assert all(v.dtype == torch.bfloat16 and not v.any() for v in c.values())


def test_prefill_decode_matches_forward():
    """The port's own teacher-forcing consistency, as the reference's
    ``test_prefill_decode_matches_forward`` has it for seamless: the
    encoder sees all 24 frames, the decoder a prefill of 16 tokens and 3
    decode steps, against the full forward (rtol 0.06, atol 0.15)."""
    cfg = preg.get_config(ARCH).smoke_model()
    model = PM.init_params(cfg, seed=0, device="cpu")
    frames, toks = _inputs(cfg, seed=3)
    frames, toks = _t(frames), torch.as_tensor(toks)
    t = 16
    with torch.no_grad():
        full = ps2s.forward(model, frames, toks).float()
        logits, caches = PM.prefill_fn(
            cfg, model, {"frames": frames, "tokens": toks[:, :t]},
            cache_len=24)
        torch.testing.assert_close(logits[:, 0].float(), full[:, t - 1],
                                   rtol=0.06, atol=0.15)
        for i in range(3):
            logits, caches = PM.decode_fn(cfg, model, caches,
                                          toks[:, t + i:t + i + 1], t + i)
            torch.testing.assert_close(logits[:, 0].float(), full[:, t + i],
                                       rtol=0.06, atol=0.15)
