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
"""
import jax
import numpy as np
import pytest
import torch

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


def _recorded_run(mod, server, vocab, monkeypatch, to_numpy):
    """Run ``server`` on the test's requests; return its result and a log
    of ("prefill", slot, logits (V,)) / ("decode", None, logits (n, V))."""
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
    out = server.run(_requests(mod, vocab))
    monkeypatch.undo()
    return out, log


@pytest.fixture(scope="module")
def runs():
    jcfg = jget("qwen2.5-3b").smoke_model()
    pcfg = pget("qwen2.5-3b").smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_jax(
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


def test_server_logits_and_tokens_match(runs):
    (ref, rlog), (port, plog) = runs
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
            np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            if int(np.argmax(g)) != int(np.argmax(w)):
                top2 = np.sort(w)[-2:]
                assert top2[1] - top2[0] < 2 * LOGIT_TOL
                live[s] = False
                flips += 1
    if flips == 0:
        assert port["results"] == {int(r): v for r, v in
                                   ref["results"].items()}


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
