"""Dense models at head dims 160 and 256, and the vision prefix in
prefill: the port against the JAX package's, on the CPU.

stablelm-12b (hd 160) and gemma-7b (hd 256) serve through the flash
kernel at head dims that ``smoke_model()`` (hd 64) never reaches. Here
each runs at its smoke config with its published head dim, ``d_model``
set to ``n_heads * head_dim`` (640 and 1024): 2 layers, reference
weights from ``PRNGKey(0)`` carried over by ``convert.params_from_jax``,
the training forward, a prefill and 3 teacher-forced decode steps
against ``repro.models``. internvl2-2b's prefill takes its 16
precomputed patch embeddings (``batch["patches"]``) added to the
prompt's prefix, as its training forward does. On the CPU the port's
prefill attention is the flash kernel's plain version.

Tolerances: ``test_torch_models.py``'s, 4e-2 absolute and relative on
logits and caches (bf16 models whose two packages round at other
places; measured up to 3.5e-2 here), and the reference's own rtol 0.06,
atol 0.15 for prefill and decode against the full forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm, model as JM
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import lm as plm, model as PM

BF16_MODEL = 4e-2
# arch -> its published head dim
WIDE = {"stablelm-12b": 160, "gemma-7b": 256}


def _wide(cfg, arch):
    hd = WIDE[arch]
    return dataclasses.replace(cfg, head_dim=hd, d_model=cfg.n_heads * hd)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, its params, port cfg, the port's converted LM)."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    if arch in WIDE:
        jcfg, pcfg = _wide(jcfg, arch), _wide(pcfg, arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, pcfg, model


def _close(got: torch.Tensor, want, tol=BF16_MODEL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_wide_head_configs(arch):
    """The cut keeps the arch's head dim and kinds; d_model follows the
    heads."""
    jcfg, _, pcfg, model = _pair(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    assert pcfg.head_dim == WIDE[arch] and pcfg.n_layers == 2
    assert pcfg.d_model == pcfg.n_heads * pcfg.head_dim
    assert tuple(model.blocks[0].attn.wq.shape) == (pcfg.d_model,
                                                    pcfg.d_model)


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_wide_head_forward_matches(arch):
    jcfg, params, _, model = _pair(arch)
    toks = _tokens(jcfg)
    want, _ = jlm.forward(jcfg, params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = plm.forward(model, torch.as_tensor(toks))
    assert got.shape == (2, 24, jcfg.vocab)
    _close(got, want)


def _prefill_and_decode(arch, patches=None, t=16, S=24):
    """Prefill of ``t`` tokens into an ``S``-long cache, then 3
    teacher-forced decode steps, in both packages: logits and k, v
    caches after each (the port's copied: its decode writes in place)."""
    jcfg, params, pcfg, model = _pair(arch)
    toks = _tokens(jcfg, S=S, seed=1)
    jbatch = {"tokens": jnp.asarray(toks[:, :t], jnp.int32)}
    pbatch = {"tokens": torch.as_tensor(toks[:, :t])}
    if patches is not None:
        jbatch["patches"] = jnp.asarray(patches, jnp.bfloat16)
        pbatch["patches"] = convert.tensor_from_numpy(
            np.asarray(jbatch["patches"]))
    jl, jc = JM.prefill_fn(jcfg, params, jbatch, cache_len=S)
    with torch.no_grad():
        pl, pc = PM.prefill_fn(pcfg, model, pbatch, cache_len=S)
    out = [(pl, jl, {n: c.clone() for n, c in pc.items()}, jc)]
    for i in range(3):
        tok = toks[:, t + i:t + i + 1]
        jl, jc = JM.decode_fn(jcfg, params, jc, jnp.asarray(tok, jnp.int32),
                              jnp.int32(t + i))
        with torch.no_grad():
            pl, pc = PM.decode_fn(pcfg, model, pc, torch.as_tensor(tok),
                                  t + i)
        out.append((pl, jl, {n: c.clone() for n, c in pc.items()}, jc))
    return jcfg, out


def _check(jcfg, out):
    for pl, jl, pc, jc in out:
        assert pl.shape == (2, 1, jcfg.vocab)
        _close(pl, jl)
        for name in ("k", "v"):
            assert pc[name].shape == jc["blocks"][name].shape
            _close(pc[name], jc["blocks"][name])


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_wide_head_prefill_and_decode_match(arch):
    """The prefill's attention (the flash path) and the decode steps at
    hd 160 and 256 against ``repro.models``; the caches hold (L, B, S,
    Hkv, hd)."""
    jcfg, out = _prefill_and_decode(arch)
    assert out[0][2]["k"].shape[-1] == WIDE[arch]
    _check(jcfg, out)


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_wide_head_prefill_decode_matches_forward(arch):
    """The port's own teacher forcing at hd 160 and 256: decode at t after
    a prefill of t tokens reproduces the full forward's logits there."""
    _, _, pcfg, model = _pair(arch)
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


def test_vision_prefill_with_patches_matches():
    """internvl2-2b's ``prefill_fn`` with ``batch["patches"]`` (B, 16,
    d_model), normal from a seed: its logits, caches and 3 decode steps
    against the reference's, and the patches change the logits (the
    prefix is used)."""
    arch = "internvl2-2b"
    jcfg, _, pcfg, model = _pair(arch)
    assert jcfg.n_vision_tokens == 16
    patches = np.random.default_rng(5).standard_normal(
        (2, jcfg.n_vision_tokens, jcfg.d_model)).astype(np.float32)
    _, out = _prefill_and_decode(arch, patches)
    _check(jcfg, out)
    plain = _prefill_and_decode(arch)[1]
    assert not torch.equal(out[0][0], plain[0][0])
