"""Training launcher: --arch <id> [--smoke] [--steps N] ...

Counterpart of ``repro.launch.train``: CUDA unless ``--device`` names
another. Every family trains: an encoder-decoder takes normal
``frames`` (B, seq, d_model) and a vision arch normal ``patches``, drawn
from ``default_rng(step)`` as the reference's launcher draws them. It
trains under ``mesh_context(make_host_mesh())``, as the reference does.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) it
first starts the default process group -- NCCL on CUDA, one GPU a local
rank (``cuda:LOCAL_RANK``), gloo on the CPU -- and trains data-parallel
over the ranks (``train.loop.make_step``); ``--batch`` is the global
batch. Without them it runs in one process on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --smoke --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.api import mesh_context
from repro_torch.train.loop import TrainConfig, Trainer, default_ckpt_dir


def extra_inputs(cfg, batch: int, seq: int, device
                 ) -> Optional[Callable[[int], Dict[str, torch.Tensor]]]:
    """The inputs beside the tokens of step ``step``, as the reference's
    launcher draws them from ``default_rng(step)``: an encoder-decoder's
    ``frames`` (batch, seq, d_model) and a vision arch's ``patches``
    (batch, n_vision_tokens, d_model), normal, float32 on ``device``;
    None for the others."""
    if cfg.family == "encdec":
        shape = (batch, seq, cfg.d_model)
        name = "frames"
    elif cfg.n_vision_tokens:
        shape = (batch, cfg.n_vision_tokens, cfg.d_model)
        name = "patches"
    else:
        return None

    def extra(step):
        rng = np.random.default_rng(step)
        return {name: torch.as_tensor(rng.normal(size=shape).astype(
            np.float32), device=device)}
    return extra


def start_process_group(device) -> torch.device:
    """Under ``torchrun``, start the default process group and return
    this rank's device: ``cuda:LOCAL_RANK`` under NCCL (raises when the
    host has fewer GPUs than local ranks), else ``device`` under gloo.
    Without torchrun's variables, ``device`` and no group."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return device
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env["LOCAL_RANK"])
    if device.type == "cuda":
        ranks_here = int(env.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < ranks_here:
            raise RuntimeError(
                f"{ranks_here} ranks on this host but "
                f"{torch.cuda.device_count()} GPUs: one GPU a rank")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=rank, world_size=world)
    return device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (smoke_model)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    arch = get_config(args.arch)
    cfg = arch.smoke_model() if args.smoke else arch.model
    owns_group = not dist.is_initialized()
    device = start_process_group(resolve_device(args.device))
    owns_group = owns_group and dist.is_initialized()

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression)
    try:
        with mesh_context(make_host_mesh()):
            trainer = Trainer(cfg, data_cfg,
                              OptConfig(lr=args.lr, total_steps=args.steps,
                                        warmup_steps=max(args.steps // 10,
                                                         5)),
                              tc, extra_batch=extra_inputs(
                                  cfg, args.batch, args.seq, device),
                              device=device)
            out = trainer.run()
        where = f" rank={dist.get_rank()}/{dist.get_world_size()}" \
            if dist.is_initialized() else ""
        # the newline in the same write: unbuffered ranks that share one
        # stdout would otherwise interleave their lines
        print(f"[done] steps={out['final_step']} "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"stragglers={out['stragglers']}{where}\n", end="", flush=True)
    finally:
        if owns_group:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
