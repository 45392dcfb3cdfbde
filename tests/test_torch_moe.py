"""The port's MoE layer against the reference's ``moe_ffn``.

Reference MoE trees from ``init_moe`` at the smoke widths of the three
MoE archs (deepseek-moe-16b: 4 experts top-2 with a shared expert;
phi3.5-moe: 4 top-2, LayerNorm model; jamba: 4 top-2), carried over by
``convert.module_params_from_jax``; inputs from ``default_rng``.

Tolerances, each with its reason:
- the experts chosen and the kept set: exact (the router runs in f32
  on bf16 inputs that are the same on both sides).
- y: 2e-2 of the largest |y| of its row (``row_rel_err``), a few bf16
  steps: each output sums the K gated expert outputs and the shared
  expert's, each rounded to bf16 at its own size (the expert GEMMs sum
  in other orders on the two sides), so an output near zero carries the
  rounding of summands of the row's size.
- aux: 1e-6 absolute (f32 means of the same probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import layers as PL

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
BF16_LAYER = 2e-2
AUX_TOL = 1e-6


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x))


def _layer(arch):
    """(reference cfg, its MoE tree, port cfg, the port's MoE)."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    p = JL.init_moe(jax.random.PRNGKey(1), jcfg)
    moe = convert.module_params_from_jax(PL.MoE(pcfg, "cpu"),
                                         jax.tree.map(np.asarray, p))
    return jcfg, p, pcfg, moe


def _x(B, S, D, seed=0, common=0.0):
    """Normal tokens plus ``common`` times one normal vector shared by all
    of them (hidden states share such a component, which skews the
    router's load)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), np.float32) \
        + common * rng.standard_normal(D).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16)


def row_rel_err(got: torch.Tensor, want) -> float:
    """The largest over rows of max|got - want| / max|want| (a row of
    zeros, a token every expert dropped, must come out as zeros)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float((np.abs(g - w).max(-1)
                  / np.maximum(np.abs(w).max(-1), 1e-30)).max())


def _reference_route(p, x, cfg):
    """The experts chosen (T, K) and kept (T, K) by the reference's own
    lines (``layers.py:360-375``), in top-k order."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = max(8, int(T * K * cfg.capacity_factor / E))
    probs = jax.nn.softmax(x.reshape(T, D).astype(jnp.float32)
                           @ p["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    fe = eidx.reshape(T * K)
    order = jnp.argsort(fe)
    se = fe[order]
    pos = jnp.arange(T * K) - jnp.searchsorted(se, jnp.arange(E))[se]
    keep = jnp.zeros(T * K, bool).at[order].set(pos < C)
    return np.asarray(eidx), np.asarray(keep).reshape(T, K)


def _port_route(moe, x, cfg):
    T = x.shape[0] * x.shape[1]
    r = PL.moe_route(moe, x.reshape(T, -1), cfg, PL.moe_capacity(cfg, T))
    K = cfg.top_k
    keep = torch.zeros(T * K, dtype=torch.bool)
    keep[torch.argsort(r.eidx.reshape(-1), stable=True)] = r.keep
    return r.eidx.numpy(), keep.view(T, K).numpy()


def _check(arch, B, S, seed, common=0.0):
    jcfg, p, pcfg, moe = _layer(arch)
    x = _x(B, S, jcfg.d_model, seed, common)
    y, aux = JL.moe_ffn(p, x, jcfg)
    with torch.no_grad():
        py, paux = PL.moe_ffn(moe, _t(x), pcfg)
        eidx, keep = _port_route(moe, _t(x), pcfg)
    want_eidx, want_keep = _reference_route(p, x, jcfg)
    np.testing.assert_array_equal(eidx, want_eidx)
    np.testing.assert_array_equal(keep, want_keep)
    assert py.dtype == torch.bfloat16 and py.shape == x.shape
    assert row_rel_err(py, y) <= BF16_LAYER
    assert paux.dtype == torch.float32
    assert abs(float(paux) - float(aux)) <= AUX_TOL
    return keep


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches(arch):
    _check(arch, 2, 16, seed=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_where_tokens_drop(arch):
    """T = 512 tokens with a shared component: 320 slots an expert for
    1024 entries on 4 experts, and the expert the router favours
    overflows; which entries it drops follows the stable sort's order."""
    keep = _check(arch, 2, 256, seed=1, common=1.0)
    assert 0 < (~keep).sum() < keep.size


def test_moe_ffn_local_is_moe_ffn():
    _, _, pcfg, moe = _layer("deepseek-moe-16b")
    x = _t(_x(2, 16, pcfg.d_model, seed=2))
    with torch.no_grad():
        y, aux = PL.moe_ffn(moe, x, pcfg)
        yl, auxl = PL.moe_ffn_local(moe, x, pcfg)
    assert torch.equal(y, yl) and torch.equal(aux, auxl)


def test_moe_combine_sums_each_token_in_expert_order():
    """The combine adds each token's kept outputs from 0.0 in f32 in
    ascending expert order, the order of the reference's scatter-add:
    the result equals that loop written out on the host."""
    _, _, pcfg, moe = _layer("deepseek-moe-16b")
    x = _t(_x(2, 16, pcfg.d_model, seed=3))
    T, K = 32, pcfg.top_k
    C = PL.moe_capacity(pcfg, T)
    with torch.no_grad():
        r = PL.moe_route(moe, x.reshape(T, -1), pcfg, C)
        out = PL.moe_experts(moe, PL.moe_dispatch(x.reshape(T, -1), r,
                                                  pcfg.n_experts, C), "silu")
        got = PL.moe_combine(out, r)
    want = np.zeros((T, pcfg.d_model), np.float32)
    eidx = r.eidx.numpy()
    st, se = r.st.numpy(), r.se.numpy()
    for t in range(T):
        for k in np.argsort(eidx[t]):
            e = int(eidx[t, k])
            j = int(np.flatnonzero((st == t) & (se == e))[0])
            if not r.keep[j]:
                continue
            val = out[e, r.pos[j]] * r.sg[j].to(torch.bfloat16)
            want[t] = want[t] + val.float().numpy()
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())
