"""AdamW with decoupled weight decay, a warmup-cosine learning rate and
global-norm clipping.

Counterpart of ``repro.optim.adamw``, in its formula and order of
operations. The moments are float32 whatever the parameter's dtype (bf16
here); the state is ``{"m": {name: f32}, "v": {name: f32}, "step": int32
0-dim}`` keyed by the port's parameter names. ``torch.optim.AdamW`` is
not a substitute: it keeps the moments in the parameter's dtype, decays
the weights before the Adam step and folds the bias corrections into the
step size, and each of these changes the trajectory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32: linear warmup
    over ``warmup_steps``, then a cosine down to ``min_lr_ratio * lr`` at
    ``total_steps``."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tree) -> Dict:
    """Zero moments in float32 beside each parameter, and step 0."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


@torch.no_grad()
def update(cfg: OptConfig, grads: Tree, state: Dict, params: Tree,
           grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step. Writes the new parameters into ``params`` and the
    new moments into ``state`` **in place** (a full-width model has no
    room for a second copy), advances ``state["step"]``, and returns
    ``(params, state, {"lr", "grad_norm"})``. ``grad_norm`` is the norm
    to clip by when ``grads`` are one rank's shards of the gradients
    (``parallel.spmd``); by default :func:`global_norm` of ``grads``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = gnorm.new_tensor(cfg.clip_norm)       # a true division, as JAX
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
