"""Fault-tolerant training loop.

Counterpart of ``repro.train.loop``:
- resumable: restores the latest checkpoint (params, optimizer state and
  step), and the stateless data pipeline regenerates batch(step)
  exactly;
- async checkpointing every ``ckpt_every`` steps, retention-managed, and
  a final blocking save;
- preemption: SIGTERM/SIGINT end the run after the step in flight, with
  a checkpoint;
- straggler watchdog: a step slower than ``straggler_factor`` x the
  running median is counted and logged;
- data parallelism under ``torch.distributed``: with a default process
  group of w ranks, each rank takes its share of every microbatch, and
  the gradients are averaged by an all-reduce in float32 (or, with int8
  compression, by an all-gather of each rank's int8 values and scale);
- optional int8 gradient compression: without a process group, the
  quantize -> dequantize transfer of a compressed all-reduce.

The model is a torch module whose parameters the step updates in place;
gradients come from autograd through the training forward
(``models.lm.forward``: blocked attention, per-layer remat).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel.api import process_group


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_compression: Optional[str] = None     # None | "int8"
    microbatches: int = 1                      # grad accumulation


def quantize_int8(g: torch.Tensor):
    """Symmetric int8 with one f32 scale (max |g| / 127); rounds half to
    even, as ``jnp.round``."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each gradient through int8 and back, in its own dtype."""
    def f(g):
        q, s = quantize_int8(g.float())
        return dequantize_int8(q, s).to(g.dtype)
    return {n: f(g) for n, g in grads.items()}


def all_reduce_mean(grads: Dict[str, torch.Tensor], world: int
                    ) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the ranks in float32 (in the dicts'
    order, the same on every rank), divided by ``world`` and cast back
    to its dtype; exact at world size 1."""
    out = {}
    for n, g in grads.items():
        t = g.float()
        dist.all_reduce(t)
        out[n] = (t / world).to(g.dtype)
    return out


def all_reduce_int8(grads: Dict[str, torch.Tensor], world: int
                    ) -> Dict[str, torch.Tensor]:
    """The compressed all-reduce: each rank quantizes its own gradient
    (``quantize_int8``, one f32 scale a leaf), the ranks all-gather the
    int8 values and the scales, and each rank dequantizes them, sums
    them in rank order from rank 0 in float32, divides by ``world`` and
    casts back. At world size 1 this is ``compress_grads`` bit for bit;
    otherwise each element is within half a step of every rank's scale,
    over ``world``, plus rounding, of the mean of the ranks' gradients."""
    out = {}
    for n, g in grads.items():
        q, s = quantize_int8(g.float())
        qs = [torch.empty_like(q) for _ in range(world)]
        ss = [torch.empty_like(s.reshape(1)) for _ in range(world)]
        dist.all_gather(qs, q)
        dist.all_gather(ss, s.reshape(1))
        acc = dequantize_int8(qs[0], ss[0][0])
        for qr, sr in zip(qs[1:], ss[1:]):
            acc = acc + dequantize_int8(qr, sr[0])
        out[n] = (acc / world).to(g.dtype)
    return out


def rank_rows(batch: Dict[str, torch.Tensor], mb: int, rank: int,
              world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s rows of a global batch of B rows in ``mb``
    microbatches: rows ``i * B / mb + rank * B / (mb * world)`` onward,
    ``B / (mb * world)`` of them, of each microbatch i, in order. So the
    ranks' rows of microbatch i, in rank order, are its rows."""
    B = batch["tokens"].shape[0]
    if B % (mb * world):
        raise ValueError(f"batch {B} does not split into {mb} microbatches "
                         f"over {world} ranks")
    b = B // (mb * world)
    return {k: v.reshape(mb, B // mb, *v.shape[1:])
            [:, rank * b:(rank + 1) * b].reshape(mb * b, *v.shape[1:])
            for k, v in batch.items()}


def make_step(cfg, opt_cfg: adamw.OptConfig, train_cfg: TrainConfig):
    """``train_step(model, opt_state, batch) -> {"loss", "lr",
    "grad_norm"}`` (0-dim tensors on the model's device): the gradients of
    ``M.loss_fn``, accumulated over ``train_cfg.microbatches`` in float32
    and divided by their count (one microbatch keeps them in the
    parameters' dtype), int8-compressed if asked, then one AdamW update
    of the model's parameters and ``opt_state`` in place.

    Under a default process group ``batch`` is the global batch: each
    rank trains on its rows of it (:func:`rank_rows`), and the loss and
    the gradients are averaged over the ranks (:func:`all_reduce_mean`,
    or :func:`all_reduce_int8` under int8 compression) before the
    update, so every rank's norm, clip and update are the same. A
    world of one rank gives the bits of the step without a group."""
    mb = train_cfg.microbatches

    def grads_of(model, params, batch):
        loss = M.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(params, grads))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        group = process_group()
        if group is not None:
            batch = rank_rows(batch, mb, *group)
        if mb > 1:
            B = batch["tokens"].shape[0]
            if B % mb:
                raise ValueError(f"batch {B} does not split into {mb} "
                                 "microbatches")
            split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                     for k, v in batch.items()}
            dev = batch["tokens"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            for i in range(mb):
                l, g = grads_of(model, params,
                                {k: v[i] for k, v in split.items()})
                loss = loss + l
                for n, acc in grads.items():
                    acc.add_(g[n])
            loss = loss / mb
            grads = {n: g / mb for n, g in grads.items()}
        else:
            loss, grads = grads_of(model, params, batch)
        int8 = train_cfg.grad_compression == "int8"
        if group is not None:
            world = group[1]
            dist.all_reduce(loss)
            loss = loss / world
            grads = (all_reduce_int8 if int8 else all_reduce_mean)(
                grads, world)
        elif int8:
            grads = compress_grads(grads)
        _, _, stats = adamw.update(opt_cfg, grads, opt_state, params)
        return {"loss": loss, **stats}

    return train_step


class Trainer:
    """Trains ``cfg``'s model from random weights (``seed``) on
    ``SyntheticLM(data_cfg)``, on ``device`` (``None`` = CUDA), resuming
    from the latest checkpoint in ``train_cfg.ckpt_dir``. ``model`` holds
    the parameters (requiring grad), ``opt_state`` the AdamW state."""

    def __init__(self, cfg, data_cfg: DataConfig,
                 opt_cfg: adamw.OptConfig = None,
                 train_cfg: TrainConfig = None, seed: int = 0,
                 extra_batch: Optional[Callable[[int], Dict]] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_cfg = train_cfg or TrainConfig()
        self.opt_cfg = opt_cfg or adamw.OptConfig(
            total_steps=self.train_cfg.steps)
        self.data = SyntheticLM(data_cfg)
        self.ckpt = CheckpointManager(self.train_cfg.ckpt_dir)
        self.extra_batch = extra_batch

        self.model = M.init_params(cfg, seed, self.device)
        self.model.requires_grad_(True)
        self.opt_state = adamw.init(dict(self.model.named_parameters()))
        self.start_step = 0
        self._preempted = False

        latest = self.ckpt.latest_step()
        if latest is not None:
            self._load(self.ckpt.restore(latest, self.state()))
            self.start_step = latest
            print(f"[trainer] resumed from step {latest}")

        self.step_fn = make_step(cfg, self.opt_cfg, self.train_cfg)

    def state(self) -> Dict[str, Any]:
        """What a checkpoint holds: the parameters and the AdamW state."""
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state}

    @torch.no_grad()
    def _load(self, host: Dict[str, Any]) -> None:
        for name, p in self.model.named_parameters():
            p.copy_(host["params"][name])
        for key in ("m", "v"):
            for name, t in self.opt_state[key].items():
                t.copy_(host["opt"][key][name])
        self.opt_state["step"] = host["opt"]["step"].to(self.device)

    def _handle_preempt(self, signum, frame):
        print(f"[trainer] signal {signum}: checkpoint + stop")
        self._preempted = True

    def _stop_requested(self) -> bool:
        """Whether a signal asked this run to stop. Under a process group
        the ranks' flags are all-reduced with MAX at every step's end, so
        that every rank saves and stops at the same step even when the
        signal reaches one rank a step before another: each rank then
        enters the same collectives in the same order."""
        if process_group() is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def run(self) -> Dict[str, Any]:
        tc = self.train_cfg
        old1 = signal.signal(signal.SIGTERM, self._handle_preempt)
        old2 = signal.signal(signal.SIGINT, self._handle_preempt)
        losses = []
        step_times = []
        stragglers = 0
        try:
            for step in range(self.start_step, tc.steps):
                t0 = time.time()
                batch = self.data.torch_batch(
                    step, self.device,
                    self.extra_batch(step) if self.extra_batch else None)
                stats = self.step_fn(self.model, self.opt_state, batch)
                loss = float(stats["loss"])
                dt = time.time() - t0
                step_times.append(dt)
                losses.append(loss)
                if len(step_times) >= 8:
                    med = statistics.median(step_times[-32:])
                    if dt > tc.straggler_factor * med:
                        stragglers += 1
                        print(f"[watchdog] step {step} took {dt:.2f}s "
                              f"(median {med:.2f}s) -- straggler")
                if step % tc.log_every == 0:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"lr={float(stats['lr']):.2e} "
                          f"gnorm={float(stats['grad_norm']):.3f} "
                          f"dt={dt:.2f}s", flush=True)
                stop = self._stop_requested()
                if (step + 1) % tc.ckpt_every == 0 or stop:
                    self.ckpt.save(step + 1, self.state())
                if stop:
                    break
        finally:
            self.ckpt.save(min(tc.steps, self.start_step + len(losses)),
                           self.state(), blocking=True)
            signal.signal(signal.SIGTERM, old1)
            signal.signal(signal.SIGINT, old2)
        return {"losses": losses, "step_times": step_times,
                "stragglers": stragglers,
                "final_step": self.start_step + len(losses)}
