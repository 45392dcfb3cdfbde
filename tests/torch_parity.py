"""Shared pieces of the port's model parity tests (imported by the
``test_torch_*`` files; no tests here): the whole-model tolerances and
MoE routing records.

Two bf16 lowerings of one model round their hidden states differently
(by about one bf16 step). Where a token's K-th and (K+1)-th router
probabilities lie closer than that rounding moves them, the reference
and the port pick different experts for it, and that token's output then
differs by a whole expert's contribution, which attention and the SSM
state carry to every later position of its sequence. So a test records
the routing of every MoE call on both sides (the calls line up one for
one) and requires the first difference in the experts chosen to be such
a near tie in the reference (gap under ``NEAR_TIE``) where the two first
part; then it runs the port again choosing the reference's experts
(:func:`follow_reference`, gates from the port's own probabilities) and
compares every position.
"""
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as PL

# Whole models at ``smoke_model()`` (logits and caches after several
# bf16 layers), (rtol, atol) per arch, each from its largest error
# measured on the CPU over the forward, prefill/decode and serving
# comparisons (the share of the tolerance it uses in brackets):
# - ``test_torch_models.py``'s 4e-2 where that holds: deepseek (logits
#   0.043, 0.90), mamba2 (an SSM state 0.053, 0.67);
# - 6e-2, the reference's rtol, as atol too, for phi3.5 (forward logits
#   0.051 on a logit near 0, 1.26 of 4e-2; 0.84) and seamless (forward
#   logits 0.066, 1.17 of 4e-2; 0.78);
# - jamba: the tolerance at which the reference holds two of its own
#   bf16 lowerings of the smoke models to each other (``test_models.py:
#   56-99``), rtol 0.06 / atol 0.15 (forward logits 0.121: 2.30 of 4e-2,
#   1.53 of 6e-2; 0.68). Its residual stream grows to |x| ~ 16 in 8
#   layers, where a bf16 step is 0.06, and its SSM states sum rounded
#   inputs over the whole prompt.
MODEL_TOL = {
    "deepseek-moe-16b": (4e-2, 4e-2),
    "mamba2-2.7b": (4e-2, 4e-2),
    "phi3.5-moe-42b-a6.6b": (6e-2, 6e-2),
    "seamless-m4t-medium": (6e-2, 6e-2),
    "jamba-v0.1-52b": (0.06, 0.15),
}

# a probability gap under which two lowerings may order two experts
# differently: a bf16 step of the hidden state (relative 2^-8) moves a
# router logit by ~1e-2, and a probability of up to 0.5 by ~5e-3
NEAR_TIE = 1e-2


class Routing(NamedTuple):
    """One MoE call of ``B`` sequences of ``S`` tokens (the reference's
    record; the port's holds 0, 0): router probabilities (T, E), the
    experts chosen (T, E) and those kept (T, E), T = B * S."""
    B: int
    S: int
    probs: np.ndarray
    chosen: np.ndarray
    kept: np.ndarray


def _routing(B, S, probs, st, se, keep) -> Routing:
    """From the entries in sorted order: token ``st``, expert ``se`` and
    whether it is kept."""
    probs, st, se = np.asarray(probs), np.asarray(st), np.asarray(se)
    chosen = np.zeros(probs.shape, bool)
    kept = np.zeros(probs.shape, bool)
    chosen[st, se] = True
    kept[st, se] = np.asarray(keep)
    return Routing(B, S, probs, chosen, kept)


def record_reference(monkeypatch, log: List[Routing]) -> None:
    """Log the routing of every call of the reference's ``moe_ffn``
    (eager, under ``jit`` or under ``scan``), computed by its own lines
    (``layers.py:360-375``)."""
    orig = JL.moe_ffn

    def rec(p, x, cfg):
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
        jax.debug.callback(
            lambda *a: log.append(_routing(B, S, *a)), probs, order // K, se,
            pos < C, ordered=True)
        return orig(p, x, cfg)
    monkeypatch.setattr(JL, "moe_ffn", rec)


def record_port(monkeypatch, log: List[Routing]) -> None:
    """Log the routing of every call of the port's ``moe_route``."""
    orig = PL.moe_route

    def rec(p, xf, cfg, C):
        r = orig(p, xf, cfg, C)
        log.append(_routing(0, 0, r.probs.detach().cpu(), r.st.cpu(),
                            r.se.cpu(),
                            r.keep.cpu()))
        return r
    monkeypatch.setattr(PL, "moe_route", rec)


def near_tie(probs: np.ndarray, K: int) -> np.ndarray:
    """Per token: the reference's K-th and (K+1)-th probabilities lie
    within ``NEAR_TIE``."""
    top = -np.sort(-probs, axis=1)
    return top[:, K - 1] - top[:, K] < NEAR_TIE


def check_routing(ref: List[Routing], port: List[Routing], K: int):
    """Fails unless the calls line up and agree on each call's size, and
    the first call whose routing differs differs only at near ties of the
    reference, in the experts chosen (the kept set follows from them).
    Later calls are not held to it: a token routed otherwise moves by a
    whole expert, and so may its later layers and positions. Returns the
    index of that first call, or None."""
    assert len(ref) == len(port), (len(ref), len(port))
    for r, p in zip(ref, port):
        assert r.chosen.shape == p.chosen.shape
    for i, (r, p) in enumerate(zip(ref, port)):
        other = (r.chosen != p.chosen).any(1)
        if not (other.any() or (r.kept != p.kept).any()):
            continue
        bad = np.nonzero(other & ~near_tie(r.probs, K))[0]
        if len(bad) or not other.any():
            pytest.fail(
                f"MoE call {i}: tokens {bad.tolist()} route to other experts "
                "without a near tie: "
                f"{np.round(np.sort(r.probs[bad], 1), 4).tolist()}, or only "
                "the kept set differs")
        return i
    return None


def follow_reference(monkeypatch, ref: List[Routing]) -> None:
    """Make the port's i-th MoE call choose the experts the reference's
    i-th call chose (in ascending order: the sorted dispatch does not
    depend on it); the gates stay the port's probabilities of them."""
    orig = PL.moe_route
    calls = iter(ref)

    def follow(p, xf, cfg, C):
        r = orig(p, xf, cfg, C)
        want = next(calls)
        assert want.chosen.shape == tuple(r.probs.shape)
        eidx = np.nonzero(want.chosen)[1].reshape(len(want.chosen), -1)
        return PL.moe_assign(r.probs, torch.as_tensor(eidx).to(
            r.eidx.device), C)
    monkeypatch.setattr(PL, "moe_route", follow)
