"""Training launcher: --arch <id> [--smoke] [--steps N] ...

Counterpart of ``repro.launch.train``, on one device: CUDA unless
``--device`` names another. Every family trains: an encoder-decoder
takes normal ``frames`` (B, seq, d_model) and a vision arch normal
``patches``, drawn from ``default_rng(step)`` as the reference's
launcher draws them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptConfig
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
    device = resolve_device(args.device)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression)
    trainer = Trainer(cfg, data_cfg,
                      OptConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 10, 5)),
                      tc, extra_batch=extra_inputs(cfg, args.batch, args.seq,
                                                   device),
                      device=device)
    out = trainer.run()
    print(f"[done] steps={out['final_step']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
