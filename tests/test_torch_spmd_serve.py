"""The sharded serving step (``parallel.spmd.ShardedLM.prefill`` and
``decode_step``: FSDP over "data", heads, experts and the vocabulary over
"model", the kv cache as ``sharding.cache_specs`` splits it) on the CPU:
four gloo ranks on a ("data", "model") (2, 2) mesh against one process
and against the reference's prefill and decode sharded on the same mesh
by XLA, over ``torch_spmd_workers.LM_CASES`` (the smoke configs of the
seven dense and MoE archs; qwen1.5-32b at 5 heads over 2, whose cache
splits ``head_dim`` over "model", where the others split kv heads; and
internvl2-2b at a vocabulary of 511 that does not divide).

Each case: a prompt of 32 tokens (``SyntheticLM``'s step 0, with the
launcher's patches) prefilled into caches of 34 positions, then 2
teacher-forced decode steps, from the reference's seed-0 weights carried
over by ``convert``. The one process runs ``model.prefill_fn`` and
``decode_fn`` under a described (2, 2) mesh (an MoE's prefill per batch
shard, its decode over the whole batch, as the reference's); the
reference runs in a subprocess with 4 forced host devices:
``jax.jit`` of its ``prefill_fn`` and ``decode_fn`` with
``in_shardings`` from its ``launch.specs`` and the caches donated, as its
dry run compiles them.

Bounds, each with its reason:
- the ranks' blocks gathered (logits of each step, caches after the
  prefill and after the last step) against one process: within the
  arch's whole-model tolerance (``torch_parity.MODEL_TOL``, or
  ``test_torch_models.BF16_MODEL`` for a dense arch), the bound the CPU
  tests hold the port's plain prefill and decode to against the
  reference's; a model rank's partial products are rounded to bf16
  before the all-reduce sums them (worst reading 0.042, deepseek);
- against the reference: within :data:`REF_TOL`, the bound at which the
  reference holds two of its own bf16 lowerings of a smoke model to
  each other (``test_models.py``'s prefill and decode against the
  forward, rtol 0.06 / atol 0.15). Its (2, 2) program is such a
  lowering: at these inputs its prefill caches differ from its own
  one-device program's by up to 0.0625 (qwen2.5-3b; 0.047 gemma-7b and
  stablelm-12b), beyond 4e-2, and so does the port's plain one process
  from it (0.047-0.058);
- each row's greedy token is the other side's, or the other side's top
  two lie within twice the bound's atol (``test_torch_serve.py``'s
  near-tie rule). An MoE's first routing call whose experts differ from
  the other side's must do so at a near tie (``torch_parity.NEAR_TIE``);
  the runs compared then choose the reference's experts on both sides;
- a world of one rank on (1, 1): ``model.prefill_fn`` and ``decode_fn``
  bit for bit, and no collective;
- every rank's collectives (``spmd.Recorder``: kind, result bytes, group
  size, in order) of the prefill and of each decode step equal those of
  the fake run of the same step that the dry run traces for rank 0
  (``launch.dryrun.trace_step``).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_models as TM
import test_torch_spmd as TS
import torch_dp_workers as DW
import torch_parity as TP
import torch_spmd_workers as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as PD
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import api
from repro_torch.parallel.sharding import cache_specs
from test_torch_spmd import _one_torch_thread  # noqa: F401 (autouse)

MESH = TS.MESH
REFERENCE = """
import os, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, NamedSharding
from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig
from repro.launch.specs import batch_specs, decode_specs, model_state_specs
from repro.launch.steps import make_serve_step
from repro.models import layers as JL, model as JM
from repro.parallel.api import filter_spec, mesh_context
from repro_torch import convert
import torch_spmd_workers as W

out = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), W.NAMES)
routes = []


def record(x, p, cfg, dp):
    # a call's router probabilities and top-k experts, shard g of its
    # batch at [g] (a decode call's 4 rows split as the ranks split them)
    xf = x.reshape(dp, -1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, p["router"]), -1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    jax.debug.callback(lambda a, b: routes.append((
        torch.as_tensor(np.sort(np.asarray(b), -1).astype(np.int64)),
        torch.as_tensor(np.asarray(a)))), probs, eidx)


local, whole = JL.moe_ffn_local, JL.moe_ffn


def recorded_local(p, x, cfg):
    record(x, p, cfg, JL._dp_shards())
    return local(p, x, cfg)


def recorded_whole(p, x, cfg):
    record(x, p, cfg, 2)
    return whole(p, x, cfg)


JL.moe_ffn_local, JL.moe_ffn = recorded_local, recorded_whole


def caches(c):
    # the reference's cache tree as the port's stacked k and v (float32)
    out = {}
    for n in ("k", "v"):
        parts = [np.asarray(h[n])[None] for h in c.get("head_blocks", [])]
        if "blocks" in c:
            parts.append(np.asarray(c["blocks"][n]))
        out[n] = torch.as_tensor(np.concatenate(parts).astype(np.float32))
    return out


def logits(x):
    return torch.as_tensor(np.asarray(x).astype(np.float32))


for case in sys.argv[2:]:
    jcfg, pcfg = W.smoke(case, jreg), W.smoke(case)
    routes.clear()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    torch.save({n: p.detach().clone() for n, p in model.named_parameters()},
               os.path.join(out, case + ".init.pt"))
    prompt, tokens = W.serve_inputs(case)
    with mesh_context(mesh):
        _, pspec, _, _ = model_state_specs(jcfg, mesh, with_opt=False)
        _, bspec = batch_specs(jcfg, ShapeConfig("p", W.S, W.B, "prefill"),
                               mesh)
        (_, _, _), (tspec, posspec, cspec) = decode_specs(
            jcfg, ShapeConfig("d", W.CACHE_LEN, W.B, "decode"), mesh)

        def prefill(p, b):
            return JM.prefill_fn(jcfg, p, b, cache_len=W.CACHE_LEN)
        lspec = NamedSharding(mesh, filter_spec(
            (("pod", "data"), None, "model"), mesh, (W.B, 1, jcfg.vocab)))
        pre = jax.jit(prefill, in_shardings=(pspec, bspec),
                      out_shardings=(lspec, cspec))
        dec = jax.jit(make_serve_step(jcfg),
                      in_shardings=(pspec, tspec, posspec, cspec),
                      out_shardings=(lspec, cspec), donate_argnums=(3,))
        params = jax.device_put(params, pspec)
        batch = {k: np.asarray(v) for k, v in prompt.items()}
        lg, c = pre(params, batch)
        rec = {"logits": [logits(lg)], "prefill_caches": caches(c)}
        for i in range(W.SERVE_STEPS):
            lg, c = dec(params, np.asarray(tokens[:, i:i + 1]),
                        jnp.int32(W.S + i), c)
            rec["logits"].append(logits(lg))
        rec["caches"] = caches(c)
    jax.effects_barrier()
    rec["routes"] = list(routes)
    torch.save(rec, os.path.join(out, case + ".serve.pt"))
"""


# (rtol, atol) against the reference's sharded program (module docstring)
REF_TOL = (0.06, 0.15)


def _tol(case):
    arch = W.CASES[case][0]
    return TP.MODEL_TOL.get(arch, (TM.BF16_MODEL, TM.BF16_MODEL))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The directory of each case's seed-0 weights (``<case>.init.pt``)
    and the reference's serving run (``<case>.serve.pt``)."""
    tmp = tmp_path_factory.mktemp("spmd_serve_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([TS.SRC, TS.TESTS] + sys.path))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp),
                          *W.LM_CASES], env=env, capture_output=True,
                         text=True, timeout=TS.REFERENCE_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return str(tmp)


def _want(reference, case):
    return torch.load(os.path.join(reference, f"{case}.serve.pt"))


def _moe_layers(case) -> int:
    cfg = W.smoke(case)
    return sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))


def _by_shard(calls):
    """Routing calls as [call][shard] = (sorted experts, probabilities)."""
    return [list(zip(e, p)) for e, p in calls]


def _one_process_calls(case, log):
    """One process's routing log (a prefill call a shard, then a decode
    call over the whole batch) as [call][shard]."""
    n = _moe_layers(case)
    out = [[log[2 * k], log[2 * k + 1]] for k in range(n)]
    for eidx, probs in log[2 * n:]:
        out.append(list(zip(eidx.chunk(2), probs.chunk(2))))
    return out


def _follow_one_process(case, calls):
    """The experts each of one process's routing calls chooses to follow
    ``calls`` ([call][shard] = experts (T, K))."""
    n = _moe_layers(case)
    flat = [e for k in range(n) for e in calls[k]]
    return flat + [torch.cat(c) for c in calls[n:]]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    follows = {"init_dir": reference}
    for case in W.LM_CASES:
        if W.smoke(case).n_experts:
            follows[case] = [[e for e, _ in shards] for shards in
                             _by_shard(_want(reference, case)["routes"])]
    tmp = tmp_path_factory.mktemp("spmd_serve4")
    return DW.run(W.serve_world, 4, tmp, MESH, follows, W.LM_CASES,
                  timeout=TS.SPAWN_TIMEOUT)


def _assemble(blocks, spec_of, whole_shape, ranks):
    """The whole tensor from the ranks' blocks under ``spec_of`` (a spec
    tuple); ranks that hold a block alike hold it bit for bit."""
    from repro_torch.parallel import spmd
    mesh = api.Mesh(W.NAMES, MESH)
    out = torch.full(whole_shape, float("nan"))
    seen = {}
    for r, t in zip(ranks, blocks):
        view = spmd.cut(out, spec_of, mesh, r["at"])
        assert tuple(view.shape) == tuple(t.shape)
        key = tuple(view.stride()) + (view.storage_offset(),)
        if key in seen:
            assert torch.equal(seen[key], t)
        seen[key] = t
        view.copy_(t.float())
    assert not torch.isnan(out).any()
    return out


def gathered(case, ranks):
    """Each step's whole logits and the whole caches after the prefill
    and after the last step, from the ranks' blocks."""
    cfg = W.smoke(case)
    mesh = api.Mesh(W.NAMES, MESH)
    shape = (W.B, 1, cfg.vocab)
    lspec = api.filter_spec((("pod", "data"), None, "model"), mesh, shape)
    out = {"logits": [_assemble([r["logits"][i] for r in ranks], lspec,
                                shape, ranks)
                      for i in range(W.SERVE_STEPS + 1)]}
    cache_shape = (cfg.n_layers, W.B, W.CACHE_LEN, cfg.n_kv_heads,
                   cfg.head_dim)
    spec = cache_specs({"k": torch.empty(cache_shape, device="meta")},
                       mesh)["k"]
    for key in ("prefill_caches", "caches"):
        out[key] = {n: _assemble([r[key][n] for r in ranks], spec,
                                 cache_shape, ranks) for n in ("k", "v")}
    return out


def _close(got, want, what, tol):
    rtol, atol = tol
    g, w = got.float().numpy(), want.float().numpy()
    err = float(np.abs(g - w).max())
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                               err_msg=f"{what}: max err {err}")
    return err


def _greedy_checked(got, want, atol):
    """Each row's argmax agrees, or ``want``'s top two are within twice
    ``atol`` (a near tie). Returns the rows that flip."""
    flips = 0
    for g, w in zip(got.float().reshape(-1, got.shape[-1]),
                    want.float().reshape(-1, want.shape[-1])):
        if int(g.argmax()) != int(w.argmax()):
            top2 = w.sort().values[-2:]
            assert float(top2[1] - top2[0]) < 2 * atol, top2
            flips += 1
    return flips


def _compared(case, ranks, want_calls):
    """The ranks' own run, or for an MoE (after its first routing
    difference from ``want_calls`` is checked to be a near tie) the run
    that chose the reference's experts; and the first difference."""
    if not W.smoke(case).n_experts:
        return ranks, None
    first = TS._first_routing_difference(want_calls, ranks)
    if first is not None:
        assert max(first[3]) < TP.NEAR_TIE, first
    return [r["followed"] for r in ranks], first


def _check(case, got, want, label, tol):
    errs = [_close(g, w, f"{case} {label} logits {i}", tol)
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"]))]
    flips = sum(_greedy_checked(g, w, tol[1])
                for g, w in zip(got["logits"], want["logits"]))
    for key in ("prefill_caches", "caches"):
        for n in ("k", "v"):
            errs.append(_close(got[key][n], want[key][n],
                               f"{case} {label} {key} {n}", tol))
    print(f"{case} against {label}: max err {max(errs):.3g}, "
          f"greedy flips {flips}")


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_four_ranks_match_one_process(case, four_ranks, reference):
    ranks = [r[case] for r in four_ranks]
    one = W.serve_one_process(case, MESH, reference)
    ranks, first = _compared(case, ranks,
                             _one_process_calls(case, one["routes"]))
    if W.smoke(case).n_experts:
        calls = [[e for e, _ in s] for s in
                 _by_shard(_want(reference, case)["routes"])]
        one = W.serve_one_process(case, MESH, reference,
                                  follow=_follow_one_process(case, calls))
    print(f"{case}: first routing difference {first}")
    _check(case, gathered(case, ranks), one, "one process", _tol(case))


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_four_ranks_match_the_reference(case, four_ranks, reference):
    want = _want(reference, case)
    ranks, first = _compared(case, [r[case] for r in four_ranks],
                             _by_shard(want["routes"]))
    print(f"{case}: first routing difference {first}")
    _check(case, gathered(case, ranks), want, "the reference", REF_TOL)


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_real_collectives_equal_the_fake_trace(case, four_ranks):
    """The prefill's and each decode step's log, on every rank and in the
    fake run of rank 0 (the prefill at the prompt's shape, the decode
    against caches of CACHE_LEN positions)."""
    import torch.distributed as dist
    logs = [r[case]["collectives"] for r in four_ranks]
    assert all(log == logs[0] for log in logs)
    assert all(step == logs[0][1] for step in logs[0][1:])
    assert not dist.is_initialized()
    new_mesh = functools.partial(make_mesh, W.NAMES, MESH)
    cfg = W.smoke(case)
    pre = PD.trace_step(cfg, ShapeConfig("p", W.S, W.B, "prefill"),
                        new_mesh, "cpu")
    dec = PD.trace_step(cfg, ShapeConfig("d", W.CACHE_LEN, W.B, "decode"),
                        new_mesh, "cpu")
    assert pre["log"] == logs[0][0]
    assert dec["log"] == logs[0][1]
    assert pre["flash_launches"] == dec["flash_launches"] == 0
    assert {k for k, _, _ in pre["log"]} <= {"all-gather", "all-reduce"}


def test_world_one_is_the_plain_prefill_and_decode(tmp_path):
    """qwen2.5-3b and deepseek-moe-16b (``torch_spmd_workers.ARCHS``) on
    one gloo rank: the plain path's logits and caches bit for bit, no
    collective."""
    (res,) = DW.run(W.serve_world_one, 1, tmp_path, W.ARCHS,
                    timeout=TS.SPAWN_TIMEOUT)
    for arch, want in res["plain"].items():
        got = res["sharded"][arch]
        assert len(got["logits"]) == W.SERVE_STEPS + 1
        for g, w in zip(got["logits"], want["logits"]):
            assert torch.equal(g, w), arch
        for key in ("prefill_caches", "caches"):
            for n, t in want[key].items():
                assert torch.equal(got[key][n], t), (arch, key, n)
        assert got["collectives"] == [[]] * (W.SERVE_STEPS + 1), arch
