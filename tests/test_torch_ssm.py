"""The port's Mamba2 layer (SSD) against the reference's.

mamba2-2.7b at ``smoke_model()`` (d_model 256, d_inner 512, 16 heads of
32, state 16, conv 4, chunk 16), the reference's Mamba tree from
``init_mamba`` carried over by ``convert.module_params_from_jax``;
inputs from ``default_rng``.

Tolerances, each with its reason:
- ``_causal_conv`` (float32 on both sides, the same shifted-add order):
  2e-6, the room XLA's fused multiply-adds leave.
- ``ssd_chunked`` and ``ssd_sequential`` in float32: 1e-4, the
  reference's own tolerance between its chunked and sequential forms
  (``test_models.py::test_ssd_chunked_equals_sequential``); the port's
  loop over chunks sums in another order than the reference's
  associative scan.
- the bf16 block, its caches and one decode step: 2e-2 relative and
  absolute, a few bf16 steps (``test_torch_models.py``'s layer tolerance).
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

ARCH = "mamba2-2.7b"
CONV_TOL = 2e-6
SSD_TOL = 1e-4
BF16_LAYER = 2e-2


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(shape, dtype, rng, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                       * scale, dtype)


@pytest.fixture(scope="module")
def layer():
    jcfg = jreg.get_config(ARCH).smoke_model()
    pcfg = preg.get_config(ARCH).smoke_model()
    p = JL.init_mamba(jax.random.PRNGKey(2), jcfg)
    m = convert.module_params_from_jax(PL.Mamba(pcfg, "cpu"),
                                       jax.tree.map(np.asarray, p))
    return jcfg, p, pcfg, m


def test_causal_conv_matches():
    rng = np.random.default_rng(0)
    u = _normal((2, 20, 48), jnp.bfloat16, rng)
    w = _normal((48, 4), jnp.bfloat16, rng, 0.5)
    b = _normal((48,), jnp.bfloat16, rng, 0.1)
    got = PL._causal_conv(_t(u), _t(w), _t(b))
    assert got.dtype == torch.float32
    _close(got, JL._causal_conv(u, w, b), CONV_TOL)


def _ssd_inputs(l, g=1, seed=0):
    """The reference test's SSD inputs (b 2, h 4, p 16, n 8), drawn from
    numpy: dt from softplus, A negative."""
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 4, 16, 8
    x = _normal((b, l, h, p), jnp.float32, rng)
    dt = jax.nn.softplus(_normal((b, l, h), jnp.float32, rng))
    A = -jnp.exp(_normal((h,), jnp.float32, rng, 0.3))
    Bm = _normal((b, l, g, n), jnp.float32, rng)
    Cm = _normal((b, l, g, n), jnp.float32, rng)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("l, g", [(64, 1), (50, 1), (64, 2)])
def test_ssd_chunked_matches_reference_and_sequential(l, g):
    """Chunk 16 over 64 steps, a ragged 50 (zero-padded to 64) and two
    groups: the port's chunked form against the reference's and against
    the port's sequential oracle, which is held to the reference's."""
    inputs = _ssd_inputs(l, g)
    pt = [_t(a) for a in inputs]
    y, s = PL.ssd_chunked(*pt, chunk=16)
    ys, ss = PL.ssd_sequential(*pt)
    jy, js = JL.ssd_chunked(*inputs, chunk=16)
    jys, jss = JL.ssd_sequential(*inputs)
    assert y.shape == (2, l, 4, 16) and s.shape == (2, 4, 16, 8)
    for got, want in ((y, jy), (s, js), (ys, jys), (ss, jss), (y, jys),
                      (s, jss)):
        _close(got, want, SSD_TOL)
    _close(y, ys.numpy(), SSD_TOL)
    _close(s, ss.numpy(), SSD_TOL)


def test_softplus_is_the_references():
    x = jnp.asarray([-30.0, -2.0, 0.0, 3.0, 19.9, 20.1, 35.0], jnp.float32)
    _close(PL.softplus(_t(x)), jax.nn.softplus(x), 1e-7)


def test_mamba_block_and_cache_match(layer):
    jcfg, p, pcfg, m = layer
    rng = np.random.default_rng(1)
    x = _normal((2, 24, jcfg.d_model), jnp.bfloat16, rng)   # chunk 16: ragged
    out, cache = JL.mamba_block(p, x, jcfg, return_cache=True)
    with torch.no_grad():
        pout, pcache = PL.mamba_block(m, _t(x), pcfg, return_cache=True)
        assert torch.equal(PL.mamba_block(m, _t(x), pcfg), pout)
    _close(pout, out, BF16_LAYER)
    assert pcache["conv"].dtype == torch.bfloat16
    assert pcache["ssm"].dtype == torch.float32
    for name in ("conv", "ssm"):
        assert pcache[name].shape == cache[name].shape
        _close(pcache[name], cache[name], BF16_LAYER)


def test_mamba_decode_matches(layer):
    """Two steps from the reference's prefill cache; the port advances
    its caches in place."""
    jcfg, p, pcfg, m = layer
    rng = np.random.default_rng(2)
    x = _normal((2, 12, jcfg.d_model), jnp.bfloat16, rng)
    _, cache = JL.mamba_block(p, x, jcfg, return_cache=True)
    conv, ssm = _t(cache["conv"]), _t(cache["ssm"])
    for step in range(2):
        xd = _normal((2, 1, jcfg.d_model), jnp.bfloat16, rng)
        out, cache = JL.mamba_decode(p, xd, jcfg, cache)
        with torch.no_grad():
            pout = PL.mamba_decode(m, _t(xd), pcfg, conv, ssm)
        _close(pout, out, BF16_LAYER)
        _close(conv, cache["conv"], BF16_LAYER)
        _close(ssm, cache["ssm"], BF16_LAYER)
