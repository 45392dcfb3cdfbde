"""Deterministic synthetic LM data pipeline.

Counterpart of ``repro.data.synthetic``, whose numpy part is copied here
unchanged, so a batch equals the reference's bit for bit. Stateless by
step: ``batch(step)`` is a pure function of (seed, step, shape), so a
restart resumes exactly and any data-parallel shard regenerates its
slice without coordination. The token stream mixes Zipf-distributed
unigrams with planted Markov motifs, so the loss falls during training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank: repeated sub-sequences give learnable structure
        self.motifs = rng.integers(0, cfg.vocab,
                                   size=(cfg.n_motifs, cfg.motif_len))
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        bsz = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + shard)
        toks = rng.choice(cfg.vocab, size=(bsz, cfg.seq_len + 1), p=self.p)
        # plant motifs so there is signal to learn
        n_plant = (cfg.seq_len // cfg.motif_len) // 2
        for b in range(bsz):
            for _ in range(n_plant):
                mi = rng.integers(0, cfg.n_motifs)
                pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[b, pos:pos + cfg.motif_len] = self.motifs[mi]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def torch_batch(self, step: int, device, extra: Optional[Dict] = None
                    ) -> Dict[str, torch.Tensor]:
        """``batch(step)`` as int32 tensors on ``device``, with ``extra``
        (tensors already on the device) merged in."""
        b = {k: torch.as_tensor(v, device=device)
             for k, v in self.batch(step).items()}
        if extra:
            b.update(extra)
        return b
