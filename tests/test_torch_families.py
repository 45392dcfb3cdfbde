"""The port's MoE, SSM and hybrid LMs against the reference's, on
converted weights.

deepseek-moe-16b (a dense first layer, then MoE with a shared expert),
phi3.5-moe (MoE on every layer, LayerNorm), mamba2-2.7b (Mamba layers
without FFN, tied embeddings) and jamba-v0.1-52b (one period-8
super-block: attention at sub-layer 4, Mamba elsewhere, MoE on the odd
sub-layers), each at ``smoke_model()``, reference weights from
``PRNGKey(0)`` carried over by ``convert.params_from_jax``.

Tolerance: logits and caches within ``torch_parity.MODEL_TOL[arch]``,
set per arch from its largest measured error: ``test_torch_models.py``'s
4e-2 for deepseek and mamba2, 6e-2 for phi3.5 (forward logits 0.051),
and for jamba (forward logits 0.121) rtol 0.06 / atol 0.15, the
reference's own tolerance between two of its bf16 lowerings of these
smoke models.
The aux loss: 2e-2 relative, the mean of router probabilities of
bf16 hidden states that differ by that much. The port first runs with
its own routing, which may part from the reference's only at a near tie
(``torch_parity``), then again choosing the reference's experts, and
every position is compared. The port's own prefill/decode
consistency takes the reference's tolerance for that check (rtol 0.06,
atol 0.15) and its ``capacity_factor=64``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as R
from repro.configs import registry as jreg
from repro.models import lm as jlm, model as JM
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import lm as plm, model as PM

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
         "jamba-v0.1-52b"]
AUX_RTOL = 2e-2


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, its params, port cfg, the port's converted LM)."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, pcfg, model


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, arch):
    rtol, atol = R.MODEL_TOL[arch]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _tokens(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _reference(monkeypatch, run):
    """``run()`` of the reference, and its routing record."""
    log = []
    with monkeypatch.context() as m:
        R.record_reference(m, log)
        out = run()
    return out, log


def _port(monkeypatch, ref_log, K, run):
    """``run()`` of the port with its own routing, which must first part
    from the reference's at a near tie if at all, then again following
    the reference's routing: that run's result, and the first call whose
    routing differed (None when none did)."""
    own = []
    with monkeypatch.context() as m, torch.no_grad():
        R.record_port(m, own)
        run()
    first = R.check_routing(ref_log, own, K)
    with monkeypatch.context() as m, torch.no_grad():
        R.follow_reference(m, ref_log)
        return run(), first


def _ref_layer_cache(jcfg, caches, i):
    """Layer ``i``'s cache in the reference's tree: a hybrid's
    ``blocks.sub{i % period}`` at ``i // period``, else ``head_blocks[i]``
    or the stacked ``blocks`` at ``i - first_k_dense``."""
    if jcfg.family == "hybrid":
        P = jcfg.hybrid_period
        return jax.tree.map(lambda a: a[i // P],
                            caches["blocks"][f"sub{i % P}"])
    if i < jcfg.first_k_dense:
        return caches["head_blocks"][i]
    return jax.tree.map(lambda a: a[i - jcfg.first_k_dense],
                        caches["blocks"])


def _check_caches(model, pc, jcfg, jc):
    """Every layer's cache row against the reference's layer cache."""
    for i, (kind, row) in enumerate(zip(model.kinds, model.rows)):
        want = _ref_layer_cache(jcfg, jc, i)
        for name in ("k", "v") if kind[0] == "attn" else ("conv", "ssm"):
            got = pc[name][row]
            assert got.shape == want[name].shape, (i, name)
            assert str(got.dtype).split(".")[-1] == \
                str(want[name].dtype), (i, name, got.dtype)
            _close(got, want[name], jcfg.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, monkeypatch):
    jcfg, params, _, model = _pair(arch)
    toks = _tokens(jcfg)
    (want, aux), ref_log = _reference(monkeypatch, lambda: jlm.forward(
        jcfg, params, jnp.asarray(toks, jnp.int32)))
    (got, paux), _ = _port(monkeypatch, ref_log, jcfg.top_k,
                           lambda: plm.forward(model, torch.as_tensor(toks)))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, jcfg.vocab)
    _close(got, want, arch)
    assert paux.dtype == torch.float32
    np.testing.assert_allclose(float(paux), float(aux), rtol=AUX_RTOL)
    assert (float(aux) > 0) == (jcfg.n_experts > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match(arch, monkeypatch):
    """Prefill of 16 tokens into a 24-long cache, then 3 teacher-forced
    decode steps, against ``repro.models``: logits and every layer's
    cache after each call."""
    jcfg, params, pcfg, model = _pair(arch)
    toks = _tokens(jcfg, seed=1)
    t = 16

    def reference():
        out = [JM.prefill_fn(jcfg, params, {"tokens": jnp.asarray(
            toks[:, :t], jnp.int32)}, cache_len=24)]
        for i in range(3):
            tok = jnp.asarray(toks[:, t + i:t + i + 1], jnp.int32)
            out.append(JM.decode_fn(jcfg, params, out[-1][1], tok,
                                    jnp.int32(t + i)))
        return out

    def port():
        logits, caches = PM.prefill_fn(
            pcfg, model, {"tokens": torch.as_tensor(toks[:, :t])},
            cache_len=24)
        out = [(logits, {k: v.clone() for k, v in caches.items()})]
        for i in range(3):
            logits, caches = PM.decode_fn(
                pcfg, model, caches, torch.as_tensor(toks[:, t + i:t + i + 1]),
                t + i)
            out.append((logits, {k: v.clone() for k, v in caches.items()}))
        return out

    want, ref_log = _reference(monkeypatch, reference)
    got, _ = _port(monkeypatch, ref_log, jcfg.top_k, port)
    for (pl, pc), (jl, jc) in zip(got, want):
        assert pl.shape == (2, 1, jcfg.vocab)
        _close(pl, jl, arch)
        _check_caches(model, pc, jcfg, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own teacher-forcing consistency, as the reference's
    ``test_prefill_decode_matches_forward`` with its
    ``capacity_factor=64`` (no token drops, which differ between one
    pass over the sequence and a step at a time)."""
    pcfg = preg.get_config(arch).smoke_model()
    if pcfg.n_experts:
        pcfg = dataclasses.replace(pcfg, capacity_factor=64.0)
    model = PM.init_params(pcfg, seed=0, device="cpu")
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


def test_layer_plan_and_cache_rows():
    """Absolute layer order: deepseek's dense head layer then MoE;
    jamba's attention at sub-layer 4 of each period and MoE on the odd
    ones; each layer's row among the layers of its mixer."""
    ds = plm.layer_kinds(preg.get_config("deepseek-moe-16b").model)
    assert ds == [("attn", "mlp")] + [("attn", "moe")] * 27
    jamba = dataclasses.replace(preg.get_config("jamba-v0.1-52b").model,
                                n_layers=16)
    kinds = plm.layer_kinds(jamba)
    assert [i for i, k in enumerate(kinds) if k[0] == "attn"] == [4, 12]
    assert [i for i, k in enumerate(kinds) if k[1] == "moe"] == \
        list(range(1, 16, 2))
    assert plm.cache_rows(kinds) == [0, 1, 2, 3, 0, 4, 5, 6,
                                     7, 8, 9, 10, 1, 11, 12, 13]
    assert plm.layer_kinds(preg.get_config("mamba2-2.7b").model) == \
        [("mamba", None)] * 64
