"""The training recipe at full width on the GPU: how the loss moves over
the first steps at a few learning rates and run lengths.

Each arch at ``chip_smoke.py``'s depth cut trains from seed 0 (weights
made on the card, batch 4) through ``Trainer`` with the launcher's
schedule (warm-up ``max(steps // 10, 5)``, cosine to ``steps``), once
for each (lr, steps) of RUNS, checkpoints off; one JSON line a run with
its losses. Then one layer of each arch at full width trains 2
``make_step`` steps (lr 1e-3, warm-up 1, B 4) from the same CPU-made
weights on the CPU and on CUDA: losses and the parameters' relative
difference over all leaves (1-2 minutes of host time an arch).

    PYTHONPATH=src python3 -m repro_torch.train.bench_recipe
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import subprocess
import tempfile
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.launch.train import extra_inputs
from repro_torch.models import model as PM
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, Trainer, make_step

# chip_smoke.py's cuts of the four dense archs (TRAIN_FAMILY_LAYERS) and
# internvl2-2b's sequence length there (caveat R10)
CUTS = {"internvl2-2b": 24, "gemma-7b": 12, "stablelm-12b": 11,
        "qwen1.5-32b": 5}
SEQ = {"internvl2-2b": 512}
BATCH = 4
RUNS = ((3e-4, 8), (3e-4, 16), (3e-4, 24), (1e-4, 8), (3e-5, 8))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def recipe_losses(cfg, lr: float, steps: int, seq: int) -> list:
    """``steps`` losses of ``cfg`` on CUDA with the launcher's schedule."""
    with tempfile.TemporaryDirectory(prefix="bench_recipe_") as d:
        tr = Trainer(cfg, DataConfig(cfg.vocab, seq, BATCH),
                     adamw.OptConfig(lr=lr, total_steps=steps,
                                     warmup_steps=max(steps // 10, 5)),
                     TrainConfig(steps=steps, ckpt_dir=d, ckpt_every=steps,
                                 log_every=steps),
                     seed=0, extra_batch=extra_inputs(cfg, BATCH, seq,
                                                      "cuda"),
                     device="cuda")
        tr.ckpt.save = lambda *a, **kw: None
        return tr.run()["losses"]


def layer_cpu_vs_cuda(cfg, seq: int) -> dict:
    """One full-width layer, 2 steps on the CPU and on CUDA."""
    cfg = dataclasses.replace(cfg, n_layers=1)
    init = PM.init_params(cfg, seed=0, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab, seq, BATCH))
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for d in ("cpu", "cuda"):
        model = copy.deepcopy(init).to(d).requires_grad_(True)
        extra = extra_inputs(cfg, BATCH, seq, d)
        step = make_step(cfg, oc, TrainConfig())
        state = adamw.init(dict(model.named_parameters()))
        losses = [float(step(model, state, data.torch_batch(
            s, d, extra(s) if extra else None))["loss"]) for s in range(2)]
        out[d] = (model, losses)
    num = den = 0.0
    for (_, c), (_, g) in zip(out["cpu"][0].named_parameters(),
                              out["cuda"][0].named_parameters()):
        c, g = c.detach().float(), g.detach().float().cpu()
        num += float(((g - c) ** 2).sum())
        den += float((c ** 2).sum())
    return dict(seq=seq, losses_cpu=out["cpu"][1],
                losses_cuda=out["cuda"][1],
                param_rel_err=math.sqrt(num / den))


def main() -> None:
    t0 = time.perf_counter()
    emit(phase="env", device=torch.cuda.get_device_name(0),
         nvidia_smi=subprocess.run(
             ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"], capture_output=True,
             text=True).stdout.strip())
    for arch, layers in CUTS.items():
        cfg = dataclasses.replace(get_config(arch).model, n_layers=layers)
        for lr, steps in RUNS:
            emit(phase="recipe", arch=arch, n_layers=layers, lr=lr,
                 steps=steps, seq=SEQ.get(arch, 128),
                 losses=recipe_losses(cfg, lr, steps, SEQ.get(arch, 128)))
            gc.collect()
            torch.cuda.empty_cache()
    for arch in CUTS:
        t = time.perf_counter()
        cfg = get_config(arch).model
        # the vision arch needs its 256 patch positions (R10)
        seq = cfg.n_vision_tokens or 32
        emit(phase="layer_cpu_vs_cuda", arch=arch,
             **layer_cpu_vs_cuda(cfg, seq), seconds=time.perf_counter() - t)
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="total", seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
