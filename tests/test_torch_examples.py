"""The torch examples (``examples/torch_*.py``) against their JAX
counterparts, on the CPU.

- quickstart at 4^3 (``run((4, 4, 4), device="cpu")``) against the
  reference modules called as ``examples/quickstart.py`` calls them:
  the three MCF values within 1e-12 (one HiGHS LP each, built by two
  packages), the synthesized optical circuits, pairs routed, ``l_max``,
  VC hop counts and deadlock freedom equal;
- fault_tolerant_pod whole (``main(["--device", "cpu"])``) against the
  reference example's own run, its calls recorded: certificate, fault
  color, dead channels, unreachable pairs, the three ``l_max``, flows
  re-routed equal; the four patterns' delivered and offered rates bit
  for bit; the resumed trainer starts at step 6 and ends at 8;
- serve_batched: the token streams of the port's ``launch.serve.main``
  equal the reference ``Server``'s on the smoke config, the reference's
  ``PRNGKey(0)`` weights carried across by ``convert``, up to a greedy
  pick at a near tie (``test_torch_serve.py``'s rule and tolerance);
- train_e2e: ``build_config`` equals the reference's field for field
  and in ``param_count()``; a short run's loss falls;
- no torch example imports ``jax`` or ``repro``; without ``--device``
  each asks for CUDA and raises where there is none.

The reference simulator calls ``jax.experimental.disable_x64``, which
this JAX release removed (caveat R1, ROADMAP §3): the fixture patches
it back only while a test runs.
"""
import ast
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.netsim as JNS
import repro.core.repair as JR
import repro.train.loop as JT
from repro.configs import base as JB, registry as jreg
from repro.core import fault as JF, synthesis as JSY, topology as JTOP
from repro.core.mcf import mcf_topology, mcf_uniform
from repro.core.pipeline import PipelineConfig, route_pod
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import convert
from repro_torch.launch import serve as pserve
from repro_torch.models import model as PM

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TORCH_EXAMPLES = ("torch_quickstart", "torch_fault_tolerant_pod",
                  "torch_serve_batched", "torch_train_e2e")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def r1_shim(monkeypatch):
    """The reference simulator, runnable for the length of one test."""
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_quickstart(spec):
    """``examples/quickstart.py``'s calls at ``spec``."""
    pt = JTOP.pt(spec)
    lam_pt, _ = mcf_uniform(pt.edges(), pt.n,
                            perms=JTOP.torus_translations(pt.pod),
                            prefer="highs")
    pdtt = JTOP.pdtt(spec)
    lam_pdtt, _ = mcf_uniform(
        pdtt.edges(), pdtt.n,
        perms=JTOP.torus_translations(pdtt.pod, twisted=True),
        prefer="highs")
    res = JSY.synthesize(spec, symmetric=True, interval=4, verbose=False)
    lam = mcf_topology(res.topology, prefer="highs")
    rp = route_pod(res.topology, PipelineConfig(
        robust=True, K=4, engine="array", local_search_rounds=3,
        vc="inplace", verify=True))
    return {"mcf_pt": lam_pt, "mcf_pdtt": lam_pdtt, "mcf_tons": lam,
            "optical": list(res.topology.optical),
            "n_routed": int(rp.table.n_routed()), "l_max": float(rp.l_max),
            "vc_counts": rp.vc_counts.tolist(),
            "deadlock_free": bool(rp.deadlock_free)}


def test_quickstart_matches_reference(one_thread):
    got = _load("torch_quickstart").run((4, 4, 4), device="cpu")
    want = _reference_quickstart((4, 4, 4))
    for k in ("mcf_pt", "mcf_pdtt", "mcf_tons"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert [tuple(map(int, e)) for e in got["optical"]] == \
        [tuple(map(int, e)) for e in want["optical"]]
    for k in ("n_routed", "l_max", "vc_counts", "deadlock_free"):
        assert got[k] == want[k], k
    assert got["deadlock_free"] and got["n_routed"] == 64 * 63


def _record_reference_pod(monkeypatch):
    """Run ``examples/fault_tolerant_pod.py``'s ``main`` with its calls
    recorded; returns the record."""
    ex = _load("fault_tolerant_pod")
    rec = {"routes": [], "sims": {}, "trainers": []}

    def wrap(name, fn):
        def f(*a, **kw):
            out = fn(*a, **kw)
            rec[name] = out
            return out
        return f

    def route(*a, **kw):
        out = route_pod(*a, **kw)
        rec["routes"].append(out.routed)
        return out

    def repair(st, dead, *a, **kw):
        rec["n_flows"] = st.table.n_flows
        return JR_repair(st, dead, *a, **kw)

    def run(tab, rate, traffic=None, **kw):
        out = JNS_run(tab, rate, traffic=traffic, **kw)
        rec["sims"][traffic.name] = (out["delivered"], out["offered"])
        return out

    class Trainer(JT.Trainer):
        def run(self):
            out = super().run()
            rec["trainers"].append((self.start_step, out["final_step"]))
            return out

    JR_repair, JNS_run = JR.repair_fault, JNS.run
    monkeypatch.setattr(ex, "route_pod", route)
    for name in ("fault_tolerance_certificate", "colors_in_use",
                 "dead_channels_for_color"):
        monkeypatch.setattr(JF, name, wrap(name, getattr(JF, name)))
    monkeypatch.setattr(JR, "repair_fault", wrap("repair", repair))
    monkeypatch.setattr(JNS, "run", run)
    monkeypatch.setattr(JT, "Trainer", Trainer)
    ex.main()
    return rec


def test_fault_tolerant_pod_matches_reference(r1_shim, one_thread,
                                              monkeypatch):
    got = _load("torch_fault_tolerant_pod").main(["--device", "cpu"])
    want = _record_reference_pod(monkeypatch)
    cert = want["fault_tolerance_certificate"]
    assert got["certificate"] == cert
    colors = want["colors_in_use"]
    assert got["fault_color"] == colors[len(colors) // 2]
    assert got["dead_channels"] == len(want["dead_channels_for_color"])
    base, fault = want["routes"]
    assert got["unreachable"] == fault.unreachable == 0
    assert got["l_max_base"] == base.l_max
    assert got["l_max_fault"] == fault.l_max
    rr = want["repair"]
    assert (got["flows_rerouted"], got["n_flows"], got["l_max_repair"]) == \
        (rr.flows_rerouted, want["n_flows"], rr.l_max)
    assert got["sims"] == want["sims"] and len(got["sims"]) == 4
    assert want["trainers"] == [(0, 6), (6, 8)]
    assert (got["start_step"], got["final_step"]) == (6, 8)


def _record_logits(mod, server, log, to_numpy, monkeypatch):
    """Record each request's logits, prefill and decode steps, into
    ``log[rid]`` while ``server`` runs."""
    prefill_fn, prefill_one, decode = \
        mod.M.prefill_fn, server._prefill_one, server._decode
    current = []

    def rec_prefill(*a, **kw):
        logits, cache = prefill_fn(*a, **kw)
        log.setdefault(current[-1], []).append(to_numpy(logits[0, -1]))
        return logits, cache

    def rec_prefill_one(slot, req):
        current.append(int(req.rid))
        return prefill_one(slot, req)

    def rec_decode(*a):
        logits, caches = decode(*a)
        rows = to_numpy(logits[:, -1])
        for slot in np.flatnonzero(server.active):
            log[int(server.rids[slot])].append(rows[slot])
        return logits, caches

    monkeypatch.setattr(mod.M, "prefill_fn", rec_prefill)
    server._prefill_one = rec_prefill_one
    server._decode = rec_decode


def test_serve_batched_matches_reference(monkeypatch):
    """The example's defaults (qwen2.5-3b's smoke model, 8 requests of 32
    tokens, 16 new, 4 slots) with the reference's weights. Every stream
    equals the reference's, except where a greedy pick falls on a near
    tie of the reference's top two logits (``test_torch_serve.py``'s
    rule: a gap under twice its logit tolerance of 4e-2); up to such a
    step the logits agree within that tolerance, and after it the stream
    is no longer compared."""
    tol = 4e-2
    jcfg = jreg.get_config("qwen2.5-3b").smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ref = jserve.Server(jcfg, params, n_slots=4, max_len=128)
    rlog, plog = {}, {}
    with monkeypatch.context() as m:
        _record_logits(jserve, ref, rlog,
                       lambda x: np.asarray(x, np.float32), m)
        rng = np.random.default_rng(0)
        want = ref.run([jserve.Request(i, rng.integers(0, jcfg.vocab, 32),
                                       16) for i in range(8)])

    class Server(pserve.Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            _record_logits(pserve, self, plog, lambda x: x.float().numpy(),
                           monkeypatch)

    def init_params(cfg, seed=0, device=None):
        return convert.params_from_jax(
            cfg, jax.tree.map(np.asarray, params), device=device)

    monkeypatch.setattr(PM, "init_params", init_params)
    monkeypatch.setattr(pserve, "Server", Server)
    ex = _load("torch_serve_batched")
    assert ex.main is pserve.main
    got = ex.main(["--device", "cpu"])
    assert (got["served"], got["decode_steps"]) == \
        (want["served"], want["decode_steps"]) == (8, 32)
    assert sorted(got["results"]) == sorted(want["results"]) == \
        list(range(8))
    for rid, stream in got["results"].items():
        ref_stream = [int(t) for t in want["results"][rid]]
        assert len(stream) == len(ref_stream) == len(rlog[rid]) == 17
        for i, (g, w) in enumerate(zip(plog[rid], rlog[rid])):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
            assert stream[i] == int(np.argmax(g))
            if stream[i] != ref_stream[i]:
                top2 = np.sort(w)[-2:]
                assert top2[1] - top2[0] < 2 * tol, (rid, i, top2)
                break
        else:
            assert stream == ref_stream


@pytest.mark.parametrize("d_model,layers", [(384, 8), (768, 8), (128, 2)])
def test_train_e2e_config_matches_reference(d_model, layers):
    ex = _load("torch_train_e2e")
    ref = _load("train_e2e")
    got = ex.build_config(d_model, layers, 8192)
    want = ref.build_config(d_model, layers, 8192)
    assert isinstance(want, JB.ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_e2e_loss_falls(one_thread, tmp_path):
    out = _load("torch_train_e2e").main(
        ["--steps", "6", "--d-model", "128", "--layers", "2", "--device",
         "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == len(out["losses"]) == 6
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_torch_examples_import_neither_jax_nor_reference():
    """No import statement names them, and loading the four examples in a
    fresh interpreter brings neither into ``sys.modules``."""
    for name in TORCH_EXAMPLES:
        roots = _imported_roots(EXAMPLES / f"{name}.py")
        assert not roots & {"jax", "jaxlib", "repro"}, (name, roots)
    code = (
        "import importlib.util, sys\n"
        f"for name in {TORCH_EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        f"        name, {str(EXAMPLES)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("name", TORCH_EXAMPLES)
def test_torch_examples_default_to_cuda(name, monkeypatch, tmp_path):
    """Without ``--device`` an example runs on the card: with none
    present it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path)] if name == "torch_train_e2e" \
        else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
