"""The port's serving loop against the reference's, on converted weights.

``test_system.py::test_serving_batched_requests``'s setup: qwen2.5-3b at
``smoke_model()``, weights from ``PRNGKey(0)``, 2 slots, a 64-long
cache, 3 requests of 8 prompt tokens and 4 new tokens each. Both servers
run with their prefill and decode logits recorded. The control flow
depends on lengths only, so the two logs line up call for call.

Tolerance: logits within 4e-2 (``test_torch_models.py``'s model
tolerance, ~10 bf16 steps of a unit logit). A greedy token may differ
only where the reference's top-2 gap is under twice that, the most two
logits each off by 4e-2 can close; after such a step that slot's stream
is no longer compared until it is refilled.

The same comparison runs for the MoE, SSM, hybrid and encoder-decoder
families (deepseek-moe-16b, mamba2-2.7b, jamba-v0.1-52b,
seamless-m4t-medium at ``smoke_model()``, weights from ``PRNGKey(0)``)
on 2 slots and prompts of falling length, 12, 8 and 5 tokens with 4 new
each, so the third request refills slot 0 with a shorter prompt. Their
logits are held to ``torch_parity.MODEL_TOL[arch]`` (4e-2 for deepseek
and mamba2, 6e-2 for seamless, rtol 0.06 / atol 0.15 for jamba), and a
greedy token may differ only where the reference's top-2 gap is under
twice the tolerance at the top logit, ``2 * (atol + rtol * |top|)``. With experts, the port runs
first with its own routing, which may differ from the reference's only
at near ties (``torch_parity``), and is compared on a second run that
chooses the reference's experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as R
from repro.configs.registry import get_config as jget
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.registry import get_config as pget
from repro_torch.launch import serve as pserve

LOGIT_TOL = 4e-2


def _requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(i, rng.integers(0, vocab, 8), 4) for i in range(3)]


def _recorded_run(mod, server, vocab, monkeypatch, to_numpy,
                  requests=_requests):
    """Run ``server`` on ``requests(mod, vocab)``; return its result and a
    log of ("prefill", slot, logits (V,)) / ("decode", None, logits (n,
    V))."""
    log = []
    prefill_fn, prefill_one = mod.M.prefill_fn, server._prefill_one
    decode = server._decode

    def rec_prefill(*a, **kw):
        logits, cache = prefill_fn(*a, **kw)
        log[-1] = ("prefill", log[-1], to_numpy(logits[0, -1]))
        return logits, cache

    def rec_prefill_one(slot, req):
        log.append(slot)
        return prefill_one(slot, req)

    def rec_decode(*a):
        logits, caches = decode(*a)
        log.append(("decode", None, to_numpy(logits[:, -1])))
        return logits, caches

    monkeypatch.setattr(mod.M, "prefill_fn", rec_prefill)
    server._prefill_one = rec_prefill_one
    server._decode = rec_decode
    out = server.run(requests(mod, vocab))
    monkeypatch.undo()
    return out, log


@pytest.fixture(scope="module")
def runs():
    jcfg = jget("qwen2.5-3b").smoke_model()
    pcfg = pget("qwen2.5-3b").smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    mp = pytest.MonkeyPatch()
    ref = _recorded_run(jserve, jserve.Server(jcfg, params, n_slots=2,
                                              max_len=64),
                        jcfg.vocab, mp, lambda x: np.asarray(x, np.float32))
    port = _recorded_run(pserve, pserve.Server(pcfg, model, n_slots=2,
                                               max_len=64, device="cpu"),
                         pcfg.vocab, mp, lambda x: x.float().numpy())
    return ref, port


def test_server_counts_match(runs):
    (ref, _), (port, _) = runs
    assert port["served"] == ref["served"] == 3
    assert port["decode_steps"] == ref["decode_steps"]
    assert sorted(port["results"]) == sorted(ref["results"])
    assert all(len(port["results"][r]) == len(ref["results"][r]) >= 4
               for r in ref["results"])


def _compare(rlog, plog, rtol, atol, tie_gap):
    """Logits call for call; a slot whose greedy token flips at a near tie
    of the reference's top two (a gap under ``tie_gap(top logit)``) is
    compared no further until refilled. Returns the number of such
    flips."""
    assert [(k, s) for k, s, _ in plog] == [(k, s) for k, s, _ in rlog]
    live = {}                  # slot -> still comparable
    flips = 0
    for (kind, slot, want), (_, _, got) in zip(rlog, plog):
        if kind == "prefill":
            live[slot] = True
            rows = [(slot, want, got)]
        else:
            rows = [(s, want[s], got[s]) for s in live]
        for s, w, g in rows:
            if not live[s]:
                continue
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
            if int(np.argmax(g)) != int(np.argmax(w)):
                top2 = np.sort(w)[-2:]
                assert top2[1] - top2[0] < tie_gap(top2[1])
                live[s] = False
                flips += 1
    return flips


def test_server_logits_and_tokens_match(runs):
    (ref, rlog), (port, plog) = runs
    if _compare(rlog, plog, LOGIT_TOL, LOGIT_TOL,
                lambda top: 2 * LOGIT_TOL) == 0:
        assert port["results"] == {int(r): v for r, v in
                                   ref["results"].items()}


# --- the other families ------------------------------------------------------

FAMILIES = ["deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
            "seamless-m4t-medium"]


def _falling_requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(i, rng.integers(0, vocab, n), 4)
            for i, n in enumerate((12, 8, 5))]


@pytest.fixture(scope="module", params=FAMILIES)
def family_runs(request):
    """(arch, top_k, the reference's run and routing, the port's run with its
    own routing and that routing, the port's run choosing the
    reference's experts)."""
    arch = request.param
    jcfg, pcfg = jget(arch).smoke_model(), pget(arch).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    mp = pytest.MonkeyPatch()

    def port_server():
        return pserve.Server(pcfg, model, n_slots=2, max_len=64,
                             device="cpu")
    ref_log, own_log = [], []
    R.record_reference(mp, ref_log)
    ref = _recorded_run(jserve, jserve.Server(jcfg, params, n_slots=2,
                                              max_len=64),
                        jcfg.vocab, mp, lambda x: np.asarray(x, np.float32),
                        _falling_requests)
    R.record_port(mp, own_log)
    own = _recorded_run(pserve, port_server(), pcfg.vocab, mp,
                        lambda x: x.float().numpy(), _falling_requests)
    R.follow_reference(mp, ref_log)
    port = _recorded_run(pserve, port_server(), pcfg.vocab, mp,
                         lambda x: x.float().numpy(), _falling_requests)
    return arch, jcfg.top_k, (ref, ref_log), (own, own_log), port


def test_family_server_counts_match(family_runs):
    _, _, ((ref, _), _), ((own, _), _), (port, _) = family_runs
    for out in (own, port):
        assert out["served"] == ref["served"] == 3
        assert out["decode_steps"] == ref["decode_steps"]
        assert sorted(out["results"]) == sorted(ref["results"])
        assert all(len(out["results"][r]) == len(ref["results"][r]) == 5
                   for r in ref["results"])


def test_family_routing_parts_only_at_a_near_tie(family_runs):
    _, K, (_, ref_log), (_, own_log), _ = family_runs
    R.check_routing(ref_log, own_log, K)


def test_family_server_logits_and_tokens_match(family_runs):
    arch, _, ((ref, rlog), _), _, (port, plog) = family_runs
    rtol, atol = R.MODEL_TOL[arch]
    if _compare(rlog, plog, rtol, atol,
                lambda top: 2 * (atol + rtol * abs(top))) == 0:
        assert port["results"] == {int(r): v for r, v in
                                   ref["results"].items()}


def test_encdec_splice_writes_the_leading_extent_only():
    """Caveat R8, kept as the reference has it: a prefill's k and v come
    padded to the cache's length, but its encoder cache (ek, ev) has the
    prompt's length, and the splice into the slot's lane writes only
    that leading extent. A refill with a shorter prompt leaves the rest
    of the lane as it was, and decode attends over all S_enc positions.
    Checked on both servers with the lanes first set to ones. (Served
    prompts are encoded from zero frames, which a model without biases
    maps to zero states, so there the tail holds zeros either way.)"""
    arch = "seamless-m4t-medium"
    jcfg, pcfg = jget(arch).smoke_model(), pget(arch).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, 5)
    ref = jserve.Server(jcfg, params, n_slots=2, max_len=16)
    ref.caches = jax.tree.map(jnp.ones_like, ref.caches)
    ref._prefill_one(0, jserve.Request(0, prompt, 4))
    port = pserve.Server(pcfg, model, n_slots=2, max_len=16, device="cpu")
    for c in port.caches.values():
        c.fill_(1)
    port._prefill_one(0, pserve.Request(0, prompt, 4))
    want = {k: np.asarray(v, np.float32)
            for k, v in ref.caches["dec_blocks"].items()}
    for name in ("k", "v", "ek", "ev"):
        got = port.caches[name].float().numpy()
        assert got.shape == want[name].shape
        np.testing.assert_array_equal(got[:, 1], 1.0)       # other lane
        tail = got[:, 0, 5:]
        np.testing.assert_array_equal(tail, want[name][:, 0, 5:])
        assert (tail == 1.0).all() == name.startswith("e")
        np.testing.assert_allclose(got[:, 0, :5], want[name][:, 0, :5],
                                   rtol=R.MODEL_TOL[arch][0],
                                   atol=R.MODEL_TOL[arch][1])


def test_server_runs_on_the_port_alone_with_random_weights():
    """The port's own init (no JAX weights): every request is served."""
    cfg = pget("qwen2.5-3b").smoke_model()
    from repro_torch.models import model as PM
    params = PM.init_params(cfg, seed=0, device="cpu")
    server = pserve.Server(cfg, params, n_slots=2, max_len=64, device="cpu")
    out = server.run(_requests(pserve, cfg.vocab))
    assert out["served"] == 3
    assert all(len(v) == 5 for v in out["results"].values())
    assert all(0 <= t < cfg.vocab for v in out["results"].values()
               for t in v)


def test_server_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pget("qwen2.5-3b").smoke_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.Server(cfg, None, n_slots=1, max_len=8)
