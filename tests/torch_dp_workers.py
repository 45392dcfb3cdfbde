"""The processes of ``test_torch_dp.py`` (no tests here): each function
runs in a rank started by :func:`run` (``torch.multiprocessing.spawn``
with a gloo group initialised from a ``file://`` path, so parallel test
workers never share a port) or in the test process itself with no
group, and writes what it found to ``<out>/rank{r}.pt``. Imports only
torch and the port."""
import dataclasses
import os
import signal
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import manager as CM
from repro_torch.configs import registry as preg
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as PL, model as PM
from repro_torch.optim import adamw
from repro_torch.parallel import api
from repro_torch.train import loop as PT

B, S, STEPS = 4, 32, 3
OPT = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
# name: (arch, opt_moe_local_dispatch, microbatches, grad_compression)
CASES = {
    "dense": ("qwen2.5-3b", False, 1, None),
    "moe_local": ("deepseek-moe-16b", True, 1, None),
    "moe_global": ("deepseek-moe-16b", False, 1, None),
    "moe_local_microbatches2": ("deepseek-moe-16b", True, 2, None),
    "dense_int8": ("qwen2.5-3b", False, 1, "int8"),
}


def run(fn, world: int, tmp, *args, before=None, timeout: float = 300.0):
    """``fn(rank, world, *args)`` in ``world`` spawned processes under a
    gloo group -- after ``before(*args)``, if given, in the same process
    before the group starts (its result under "before") -- and each
    rank's result; fails if a rank fails or the ranks take longer than
    ``timeout`` seconds (they are killed then)."""
    init = os.path.join(tmp, "init")
    ctx = mp.spawn(_entry, args=(fn, before, world, init, str(tmp)) + args,
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(world)]


def _entry(rank, fn, before, world, init, out, *args):
    torch.set_num_threads(1)
    first = before(*args) if before else None
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        if before:
            result["before"] = first
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _route_log(log):
    """Patch ``PL.moe_route`` to log each call's sorted experts and its
    router probabilities. Returns the original."""
    orig = PL.moe_route

    def route(p, xf, cfg, C):
        r = orig(p, xf, cfg, C)
        log.append((r.eidx.sort(dim=1).values.clone(),
                    r.probs.detach().clone()))
        return r
    PL.moe_route = route
    return orig


def train_case(name: str, mesh=None):
    """``STEPS`` steps of ``make_step`` on case ``name``'s smoke model
    from seed 0 under ``mesh``: losses, grad norms, the parameters and
    every routing call."""
    arch, local, mb, compression = CASES[name]
    cfg = dataclasses.replace(preg.get_config(arch).smoke_model(),
                              opt_moe_local_dispatch=local)
    model = PM.init_params(cfg, 0, "cpu").requires_grad_(True)
    state = adamw.init(dict(model.named_parameters()))
    step = PT.make_step(cfg, OPT, PT.TrainConfig(
        microbatches=mb, grad_compression=compression))
    data = SyntheticLM(DataConfig(cfg.vocab, S, B))
    log, losses, norms = [], [], []
    orig = _route_log(log)
    try:
        with api.mesh_context(mesh):
            for s in range(STEPS):
                stats = step(model, state, data.torch_batch(s, "cpu"))
                losses.append(stats["loss"].clone())
                norms.append(stats["grad_norm"].clone())
    finally:
        PL.moe_route = orig
    return {"losses": losses, "norms": norms, "routes": log,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def steps(rank, world, names):
    """Every case in ``names`` under ``make_host_mesh()``."""
    mesh = make_host_mesh()
    assert mesh.shape == (world, 1) and api.processes() == world
    return {n: train_case(n, mesh) for n in names}


def no_group(names):
    """Every case in ``names`` with no group and no mesh: today's step."""
    return {n: train_case(n) for n in names}


def world_one(rank, world, names):
    """At world size 1: every case under ``make_host_mesh()`` (a (1, 1)
    mesh over the one rank), and the compressed all-reduce."""
    mesh = make_host_mesh()
    assert mesh.shape == (1, 1) and api.processes() == 1
    return {"steps": {n: train_case(n, mesh) for n in names},
            **int8_allreduce(rank, world)}


def grads_of_rank(rank: int):
    """Random gradients of rank ``rank``: f32 and bf16 leaves, one of all
    zeros."""
    g = torch.Generator().manual_seed(100 + rank)
    return {"a": torch.randn(64, 33, generator=g) * (1 + rank),
            "b": (torch.randn(257, generator=g) * 1e-3).bfloat16(),
            "zero": torch.zeros(5, 3)}


def int8_allreduce(rank, world):
    """This rank's gradients, its int8 scales, the compressed all-reduce
    of every rank's and ``compress_grads`` of its own."""
    grads = grads_of_rank(rank)
    return {"grads": grads,
            "scales": {n: PT.quantize_int8(g.float())[1]
                       for n, g in grads.items()},
            "reduced": PT.all_reduce_int8(grads, world),
            "compressed": PT.compress_grads(grads)}


def wsc_and_mesh(rank, world):
    """``make_host_mesh()`` and ``wsc`` in a group: a replicated DTensor
    redistributed to ("data", None) holds this rank's rows; a plain
    tensor passes unchanged; ``named`` gives the placements."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = make_host_mesh()
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    with api.mesh_context(mesh):
        plain = api.wsc(x, "data", None)
        d = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate(), Replicate()])
        sharded = api.wsc(d, ("pod", "data"), None)
        kept = api.wsc(d, None, "model")
        named = api.named(("data",), (8, 3))
    return {"mesh": (mesh.axis_names, mesh.shape, api.processes()),
            "plain_is_x": plain is x,
            "sharded_placements": _placements(sharded.placements),
            "sharded_local": sharded.to_local().clone(),
            "model_placements": _placements(kept.placements),
            "model_local": kept.to_local().clone(),
            "named": _placements(named)}


def _placements(ps):
    return [(type(p).__name__, getattr(p, "dim", None)) for p in ps]


def resume(rank, world, root):
    """``Trainer`` on the deepseek smoke model with local dispatch, under
    ``make_host_mesh()`` (B 4, S 16, a checkpoint every 2 steps): 4
    steps straight into ``root/straight``; 2 steps into ``root/resumed``,
    then a new Trainer resumes there and runs to 4. Which ranks wrote
    checkpoint files, and both runs' parameters."""
    writers = []
    start = CM.CheckpointManager._start

    def logged(self, *a, **kw):
        writers.append(rank)
        return start(self, *a, **kw)
    CM.CheckpointManager._start = logged
    cfg = preg.get_config("deepseek-moe-16b").smoke_model()
    cfg = dataclasses.replace(cfg, opt_moe_local_dispatch=True)

    def trainer(d, steps):
        return PT.Trainer(cfg, DataConfig(cfg.vocab, 16, B), OPT,
                          PT.TrainConfig(steps=steps, ckpt_dir=d,
                                         ckpt_every=2),
                          seed=0, device="cpu")
    out = {}
    try:
        with api.mesh_context(make_host_mesh()):
            straight = trainer(os.path.join(root, "straight"), 4)
            out["straight_losses"] = straight.run()["losses"]
            first = trainer(os.path.join(root, "resumed"), 2)
            out["first_losses"] = first.run()["losses"]
            second = trainer(os.path.join(root, "resumed"), 4)
            out["start_step"] = second.start_step
            out["second_losses"] = second.run()["losses"]
    finally:
        CM.CheckpointManager._start = start
    out["writers"] = writers
    for key, tr in (("straight", straight), ("resumed", second)):
        out[key] = {n: p.detach().clone()
                    for n, p in tr.model.named_parameters()}
        out[key + "_opt"] = {k: {n: t.clone() for n, t in v.items()}
                             for k, v in tr.opt_state.items() if k != "step"}
    return out


def preempt(rank, world, root, signalled, at):
    """``Trainer`` on the dense smoke model under ``make_host_mesh()`` (B
    4, S 16, 6 steps, no periodic checkpoint); rank ``signalled`` sends
    itself SIGTERM as it starts step ``at``, so only it sees the signal.
    Its run, whether it saw the signal, and the checkpoint steps on
    disk."""
    cfg = preg.get_config("qwen2.5-3b").smoke_model()

    def extra(step):
        if rank == signalled and step == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return None
    with api.mesh_context(make_host_mesh()):
        tr = PT.Trainer(cfg, DataConfig(cfg.vocab, 16, B), OPT,
                        PT.TrainConfig(steps=6, ckpt_dir=root,
                                       ckpt_every=100),
                        seed=0, extra_batch=extra, device="cpu")
        res = tr.run()
    return {**res, "saw_signal": tr._preempted,
            "ckpt_steps": sorted(tr.ckpt.all_steps())}


AUX_WEIGHT = 0.01


def moe_layer_case(local: bool):
    """deepseek's smoke MoE layer from seed 0, its config with
    ``opt_moe_local_dispatch`` as ``local``, 4 x 64 tokens with a shared
    component (so that experts overflow) and a cotangent."""
    cfg = dataclasses.replace(
        preg.get_config("deepseek-moe-16b").smoke_model(),
        opt_moe_local_dispatch=local)
    moe = PL.init_weights_(PL.MoE(cfg, "cpu"), 0).requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 64, cfg.d_model, generator=g)
         + torch.randn(cfg.d_model, generator=g)).bfloat16()
    ct = torch.randn(x.shape, generator=g).bfloat16()
    return cfg, moe, x, ct


def moe_layer(cfg, moe, x, ct, mesh, rows=slice(None), y_weight=1.0):
    """y, aux and the gradients of ``y_weight * sum(y * ct) + AUX_WEIGHT
    * aux`` for this process's ``rows`` of x under ``mesh``: the input's
    and each MoE leaf's."""
    ffn = PL.moe_ffn_local if cfg.opt_moe_local_dispatch else PL.moe_ffn
    xr = x[rows].clone().requires_grad_(True)
    with api.mesh_context(mesh):
        y, aux = ffn(moe, xr, cfg)
        loss = y_weight * (y.float() * ct[rows].float()).sum() \
            + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, [xr] + list(moe.parameters()))
    return {"y": y.detach(), "aux": aux.detach(), "x_grad": grads[0],
            "grads": dict(zip([n for n, _ in moe.named_parameters()],
                              grads[1:]))}


def moe_layers(rank, world):
    """Each rank's half of the batch through ``moe_ffn_local`` (one shard
    a rank) and through the global ``moe_ffn``, under ``make_host_mesh()``;
    the parameter gradients averaged over the ranks, as ``make_step``
    averages them."""
    mesh = make_host_mesh()
    out = {}
    for local in (True, False):
        cfg, moe, x, ct = moe_layer_case(local)
        b = x.shape[0] // world
        res = moe_layer(cfg, moe, x, ct, mesh,
                        slice(rank * b, (rank + 1) * b))
        res["grads"] = PT.all_reduce_mean(res["grads"], world)
        out[local] = res
    return out
