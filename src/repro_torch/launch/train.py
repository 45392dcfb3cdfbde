"""Training launcher: --arch <id> [--smoke] [--steps N] ...

Counterpart of ``repro.launch.train``, on one device: CUDA unless
``--device`` names another. The dense family trains (ROADMAP item 10);
the others raise in the loss (item 10b).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import TrainConfig, Trainer, default_ckpt_dir


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

    extra = None
    if cfg.n_vision_tokens:
        def extra(step):
            rng = np.random.default_rng(step)
            return {"patches": torch.as_tensor(rng.normal(size=(
                args.batch, cfg.n_vision_tokens,
                cfg.d_model)).astype(np.float32), device=device)}

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     microbatches=args.microbatches,
                     grad_compression=args.grad_compression)
    trainer = Trainer(cfg, data_cfg,
                      OptConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 10, 5)),
                      tc, extra_batch=extra, device=device)
    out = trainer.run()
    print(f"[done] steps={out['final_step']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
