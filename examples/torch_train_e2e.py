"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen-family model with the full substrate (sharded synthetic data,
AdamW + cosine, remat, async checkpointing, resume, straggler
watchdog). The counterpart of ``train_e2e.py``.

Default runs a shortened schedule sized for a CPU; pass --steps 300
--d-model 768 for the full ~100M x few-hundred-step run. The run resumes
from the latest checkpoint in --ckpt-dir.

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--steps N] [--device cpu]
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.loop import TrainConfig, Trainer  # noqa: E402


def build_config(d_model: int, n_layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name="e2e-100m", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=d_model // 64, n_kv_heads=d_model // 128,
        head_dim=64, d_ff=4 * d_model, vocab=vocab, qkv_bias=True,
        tie_embeddings=True, attn_block=128, ssm_chunk=64)


def main(argv=None) -> dict:
    """Train and print the loss's first and last values; returns the
    trainer's result (``losses``, ``step_times``, ``stragglers``,
    ``final_step``) with ``n_params``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_config(args.d_model, args.layers, args.vocab)
    n_params = cfg.param_count()
    print(f"model: {n_params / 1e6:.1f}M params "
          f"({args.layers}L x {args.d_model})")

    tc = TrainConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                     ckpt_dir=args.ckpt_dir, log_every=5,
                     microbatches=args.microbatches)
    trainer = Trainer(
        cfg, DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch),
        OptConfig(lr=6e-4, warmup_steps=max(args.steps // 10, 5),
                  total_steps=args.steps),
        tc, device=device)
    out = trainer.run()
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} over "
          f"{len(out['losses'])} steps "
          f"(median step {sorted(out['step_times'])[len(out['step_times']) // 2]:.2f}s)")
    assert out["losses"][-1] < out["losses"][0], "training must make progress"
    return dict(out, n_params=n_params)


if __name__ == "__main__":
    main()
