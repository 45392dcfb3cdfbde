"""The sharded training step (``parallel.spmd``: FSDP over "data", tensor
and expert parallelism over "model") on the CPU: four gloo ranks on a
("data", "model") (2, 2) mesh against one process, and against the
reference's step sharded on the same mesh by XLA.

The ranks run in processes spawned by ``torch_dp_workers.run`` (a
``file://`` rendezvous under ``tmp_path``, killed after a timeout), one
torch thread each, as is the one-process run here. The cases
(``torch_spmd_workers.LM_CASES``) are the smoke configs of the seven
dense and MoE archs, two of them reshaped so that every branch a
production cell takes runs: q heads that do not divide over "model"
(qwen1.5-32b's 40 over 16, here 5 over 2) and a vocabulary that does not
divide (internvl2-2b's 92553, here 511, beside its smoke vocabulary of
512, where patches meet the vocab-parallel embedding). The SSM, hybrid
and encoder-decoder families run the same checks (the ``check_*``
functions here) in ``test_torch_spmd_families.py``. Each starts from the
reference's seed-0 weights carried over by ``convert``; batches from
``SyntheticLM`` (B 4, S 32) with the launcher's patches, 3 steps at lr
1e-3 (``torch_spmd_workers``). The one process runs
``train.loop.make_step`` under a described (2, 2) mesh, an MoE with the
per-shard dispatch, whose capacity and routing per data shard are the
sharded step's. The reference runs in a subprocess with 4 forced host
devices: ``jax.jit`` of its ``train.loop.make_step`` (the same config,
the same ``OptConfig``) with ``in_shardings`` from its
``launch.specs.model_state_specs`` and ``batch_specs``, as its dry run
compiles the step, executed 3 times on the same batches.

Bounds, each with its reason:
- the four ranks against one process and against the reference: each
  loss within ``test_torch_dp.LOSS_RTOL`` and the gathered parameters
  within :data:`PARAM_REL` after 3 steps, the bounds the CPU tests hold
  three steps of each arch in one process to against the reference
  (``test_torch_dp``, ``test_torch_train_archs``,
  ``test_torch_train_families``): a model rank's partial products are
  rounded to bf16 before the all-reduce sums them, where one process
  rounds the whole product once, and a data rank's bf16 gradient is
  rounded before FSDP's mean. The worst readings on the CPU are
  printed (``-s``) and stand in ``PERF.md``. Each step's gradient norm
  within ``test_torch_dp.LAYER_GRAD_REL``, the bound on one layer's
  gradients leaf by leaf: the norm's relative error is at most the
  largest leaf's (a gradient scaled on some ranks, which Adam's update
  hides, shows here). For an MoE, the first routing call where the
  ranks' own experts differ from the other side's must do so at a near
  tie (``torch_parity.NEAR_TIE``); the runs compared then choose the
  reference's experts on every side (``torch_parity``'s rule, the
  reference's routing recorded in its sharded step);
- a world of one rank on a (1, 1) mesh: today's step bit for bit;
- ``shard_state`` then ``gather_state``: the parameters bit for bit,
  each shard the shape ``launch.specs.local_shape`` gives;
- the collectives each rank issued (``spmd.Recorder``: kind, result
  bytes, group size, in order) equal those of the fake run of the same
  step that the dry run traces for rank 0 (``launch.dryrun.trace_step``
  under a fake group of 4 ranks).
"""
import functools
import os
import subprocess
import sys

import pytest
import torch

import test_torch_dp as TD
import test_torch_train_archs as TA
import test_torch_train_families as TF
import test_torch_train_seq2seq as TS2
import torch_dp_workers as DW
import torch_parity as TP
import torch_spmd_workers as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as PD, specs as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as PM
from repro_torch.parallel import api, spmd

MESH = (2, 2)
SPAWN_TIMEOUT = 300.0
REFERENCE_TIMEOUT = 600
TESTS = os.path.dirname(__file__)
SRC = os.path.join(TESTS, "..", "src")
# each case's arch's bound (module docstring)
PARAM_REL = {**TD.PARAM_REL, **TA.PARAM_REL, **TF.PARAM_REL,
             "seamless-m4t-medium": TS2.PARAM_REL}
REFERENCE = """
import dataclasses, os, sys
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig
from repro.launch.specs import batch_specs, model_state_specs
from repro.models import layers as JL, model as JM
from repro.optim import adamw as JA
from repro.parallel.api import mesh_context
from repro.train import loop as JT
from repro_torch import convert
import torch_spmd_workers as W

out = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), W.NAMES)
shape = ShapeConfig("c", W.S, W.B, "train")
opt_cfg = JA.OptConfig(**{f.name: getattr(W.OPT, f.name)
                          for f in dataclasses.fields(W.OPT)})


routes = []
local = JL.moe_ffn_local


def recorded(p, x, cfg):
    # the routing of each call, by moe_ffn_local's own lines: per data
    # shard, the f32 router's probabilities and the top-k experts
    B, S, D = x.shape
    dp = JL._dp_shards()
    xf = x.reshape(dp, B * S // dp, D).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, p["router"]), -1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    jax.debug.callback(lambda a, b: routes.append((
        torch.as_tensor(np.sort(np.asarray(b), -1).astype(np.int64)),
        torch.as_tensor(np.asarray(a)))), probs, eidx)
    return local(p, x, cfg)


JL.moe_ffn_local = recorded


def port(cfg, params):
    model = convert.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {n: p.detach().clone() for n, p in model.named_parameters()}


for case in sys.argv[2:]:
    jcfg, pcfg = W.smoke(case, jreg), W.smoke(case)
    routes.clear()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    torch.save(port(pcfg, params), os.path.join(out, case + ".init.pt"))
    with mesh_context(mesh):
        _, pspec, _, ospec = model_state_specs(jcfg, mesh, with_opt=True)
        _, bspec = batch_specs(jcfg, shape, mesh)
        rep = NamedSharding(mesh, P())
        step = jax.jit(JT.make_step(jcfg, opt_cfg, JT.TrainConfig()),
                       in_shardings=(pspec, ospec, bspec),
                       out_shardings=(pspec, ospec, {
                           "loss": rep, "lr": rep, "grad_norm": rep}),
                       donate_argnums=(0, 1))
        params = jax.device_put(params, pspec)
        opt = jax.device_put(JA.init(params), ospec)
        losses, norms = [], []
        for s in range(W.STEPS):
            batch = {k: np.asarray(v) for k, v in W.batch(case, s).items()}
            params, opt, stats = step(params, opt, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
    jax.effects_barrier()
    torch.save({"losses": losses, "norms": norms,
                "params": port(pcfg, params),
                "routes": list(routes)},
               os.path.join(out, case + ".ref.pt"))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_reference(tmp_path_factory, cases) -> str:
    """The directory where the reference subprocess left each of
    ``cases``' seed-0 weights (``<case>.init.pt``) and its losses and
    parameters after 3 sharded steps (``<case>.ref.pt``), under the
    port's names."""
    tmp = tmp_path_factory.mktemp("spmd_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([SRC, TESTS] + sys.path))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp),
                          *cases], env=env, capture_output=True,
                         text=True, timeout=REFERENCE_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return str(tmp)


def run_four_ranks(tmp_path_factory, reference, cases):
    """Each rank's results of ``cases`` (``torch_spmd_workers.world``)."""
    tmp = tmp_path_factory.mktemp("spmd4")
    return DW.run(W.world, 4, tmp, MESH, reference, tuple(cases),
                  timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, W.LM_CASES)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    return run_four_ranks(tmp_path_factory, reference, W.LM_CASES)


def _first_routing_difference(want, ranks):
    """The first routing call (k, shard g) in call order whose experts
    in a rank holding shard g differ from ``want[k][g]`` (sorted experts,
    probabilities), with the tokens that differ and their top-k gaps in
    ``want``'s probabilities; or None."""
    assert len(want) == len(ranks[0]["routes"])
    for k, shards in enumerate(want):
        for g, (eidx, probs) in enumerate(shards):
            for r in ranks:
                if r["at"]["data"] != g:
                    continue
                other = r["routes"][k][0]
                if not torch.equal(eidx, other):
                    toks = torch.nonzero((eidx != other).any(1)).flatten()
                    top = probs.sort(dim=1, descending=True).values
                    K = eidx.shape[1]
                    return k, g, toks.tolist(), (top[toks, K - 1]
                                                 - top[toks, K]).tolist()
    return None


def _gathered(case, ranks, init_dir):
    """The whole parameters from the ranks' shards; the ranks that hold a
    block alike hold it bit for bit."""
    mesh = api.Mesh(W.NAMES, MESH)
    whole = W.initial(case, init_dir)
    full = spmd.gather_state([r["params"] for r in ranks], whole, mesh)
    for rank, r in enumerate(ranks):
        for n, t in spmd.shard_state(_as_model(whole, full), mesh,
                                     rank).items():
            assert torch.equal(r["params"][n], t), (rank, n)
    for r in ranks[1:]:
        for key in ("losses", "norms"):
            assert all(torch.equal(a, b) for a, b in zip(r[key],
                                                         ranks[0][key]))
    return full


def _rel(ranks, full, want):
    def worst(key):
        return max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(ranks[0][key], want[key]))
    return worst("losses"), worst("norms"), TD._param_rel(full,
                                                          want["params"])


def _routing_checked(case, ranks, want):
    """For an MoE: the first routing call where the ranks' own experts
    differ from ``want`` (one process's or the reference's) must do so at
    a near tie of ``want``'s probabilities; then the ranks' run that
    chose the reference's experts (``torch_parity``'s rule: later calls
    are not held to it, as a token routed otherwise moves by a whole
    expert). The ranks' own run for a dense arch. Returns (the ranks'
    results, the first difference)."""
    if not W.smoke(case).n_experts:
        return ranks, None
    first = _first_routing_difference(want, ranks)
    if first is not None:
        assert max(first[3]) < TP.NEAR_TIE, first
    return [r["followed"] for r in ranks], first


def check_one_process(case, four_ranks, reference):
    """An MoE's one process and ranks both choose the reference's experts
    in the runs compared (:func:`_routing_checked`)."""
    ranks = [r[case] for r in four_ranks]
    one = W.one_process(case, MESH, reference)
    routes = one["routes"]
    ranks, first = _routing_checked(case, ranks, [
        [routes[2 * k], routes[2 * k + 1]] for k in range(len(routes) // 2)])
    if W.smoke(case).n_experts:
        one = W.one_process(case, MESH, reference, follow=True)
    full = _gathered(case, ranks, reference)
    loss_rel, norm_rel, param_rel = _rel(ranks, full, one)
    print(f"{case}: loss rel {loss_rel:.3g}, norm rel {norm_rel:.3g}, "
          f"params rel {param_rel:.3g}, first routing difference {first}")
    assert loss_rel <= TD.LOSS_RTOL, loss_rel
    assert norm_rel <= TD.LAYER_GRAD_REL, norm_rel
    assert param_rel <= PARAM_REL[W.CASES[case][0]], param_rel


def check_reference(case, four_ranks, reference):
    """The reference's step, jitted with its specs on a (2, 2) mesh of
    forced host devices and run 3 times from the same weights on the
    same batches; an MoE's ranks choosing its experts
    (:func:`_routing_checked`)."""
    want = torch.load(os.path.join(reference, f"{case}.ref.pt"))
    ranks, first = _routing_checked(case, [r[case] for r in four_ranks],
                                    [list(zip(e, p)) for e, p in
                                     want["routes"]])
    full = _gathered(case, ranks, reference)
    loss_rel, norm_rel, param_rel = _rel(ranks, full, want)
    print(f"{case} against the reference: loss rel {loss_rel:.3g}, norm "
          f"rel {norm_rel:.3g}, params rel {param_rel:.3g}, first routing "
          f"difference {first}")
    assert loss_rel <= TD.LOSS_RTOL, loss_rel
    assert norm_rel <= TD.LAYER_GRAD_REL, norm_rel
    assert param_rel <= PARAM_REL[W.CASES[case][0]], param_rel


def _as_model(model, params):
    """``model`` holding ``params`` (a copy of its structure on the CPU)."""
    import copy
    out = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(params[n])
    return out


def check_world_one(tmp_path, archs):
    """One gloo rank on (1, 1): the losses and parameters of today's
    ``make_step`` bit for bit, for each of ``archs``; no collective
    run, no weight read through a view."""
    (res,) = DW.run(W.world_one, 1, tmp_path, tuple(archs),
                    timeout=SPAWN_TIMEOUT)
    for arch, want in res["today"].items():
        got = res["sharded"][arch]
        assert all(torch.equal(a, b) for a, b in zip(got["losses"],
                                                     want["losses"])), arch
        for n, p in want["params"].items():
            assert torch.equal(got["params"][n], p), (arch, n)
        assert got["collectives"] == [[]] * W.STEPS
        assert not any(got["views"].values()), (arch, got["views"])


def test_world_one_is_todays_step(tmp_path):
    """Both archs (``torch_spmd_workers.ARCHS``)."""
    check_world_one(tmp_path, W.ARCHS)


SHAPES = [(2, 2), (1, 4), (4, 1), (2, 2, 2)]


def check_shard_gather(arch, shape):
    names = W.NAMES if len(shape) == 2 else ("pod",) + W.NAMES
    mesh = api.Mesh(names, shape)
    model = PM.init_params(W.smoke(arch), 0, "cpu")
    shards = [spmd.shard_state(model, mesh, r) for r in range(mesh.size)]
    spec = spmd.specs(model, mesh)
    for n, p in model.named_parameters():
        for s in shards:
            assert tuple(s[n].shape) == PS.local_shape(p.shape, spec[n],
                                                       mesh), n
    for n, t in spmd.gather_state(shards, model, mesh).items():
        assert torch.equal(t, model.get_parameter(n)), n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", W.ARCHS)
def test_shard_state_then_gather_is_lossless(arch, shape):
    check_shard_gather(arch, shape)


def check_fake_trace(arch, four_ranks):
    """Every rank's log of each step, and the fake rank 0's of the first,
    are one sequence: the same kinds, result bytes and group sizes."""
    import torch.distributed as dist
    logs = [r[arch]["collectives"] for r in four_ranks]
    assert all(log == logs[0] for log in logs)
    assert all(step == logs[0][0] for step in logs[0])
    assert not dist.is_initialized()
    fake = PD.trace_step(W.smoke(arch), ShapeConfig("c", W.S, W.B, "train"),
                         functools.partial(make_mesh, W.NAMES, MESH), "cpu")
    assert fake["log"] == logs[0][0]
    kinds = {k for k, _, _ in fake["log"]}
    assert kinds == {"all-gather", "all-reduce", "reduce-scatter"}


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_four_ranks_match_one_process(case, four_ranks, reference):
    check_one_process(case, four_ranks, reference)


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_four_ranks_match_the_reference(case, four_ranks, reference):
    check_reference(case, four_ranks, reference)


@pytest.mark.parametrize("arch", list(W.LM_CASES))
def test_real_collectives_equal_the_fake_trace(arch, four_ranks):
    check_fake_trace(arch, four_ranks)
