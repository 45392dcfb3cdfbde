"""Batched serving loop with continuous batching over fixed decode slots.

Counterpart of ``repro.launch.serve``, with the same semantics, the
reference's approximations included: prompts are prefilled one request at
a time, every decode step advances all slots at one uniform position,
the largest of the slots' positions (ROADMAP caveat R6), and an
encoder-decoder's prompt is encoded from zero frames of its length into a
cache of ``max_len`` encoder positions (caveat R8). Serves every family
of ``repro_torch.configs``. Runs on CUDA by
default (prefill attention on the hand-written flash kernel); pass
``device="cpu"`` for the plain torch path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: Optional[List[int]] = None


class Server:
    """Fixed-slot continuous batching: each slot holds one sequence; free
    slots are refilled from the queue (prefill), all active slots advance
    one token per decode step. ``params`` must lie on ``device``."""

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 256,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.caches = M.empty_cache(cfg, n_slots, max_len, S_enc=max_len,
                                    device=self.device)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.long,
                                  device=self.device)
        self.pos = np.zeros(n_slots, np.int32)
        self.remaining = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.rids = np.full(n_slots, -1)
        self.results = {}
        self._decode = lambda p, c, t, pos: M.decode_fn(cfg, p, c, t, pos)

    def _prefill_one(self, slot: int, req: Request):
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=self.device)[None, :]
        batch = {"tokens": prompt}
        if self.cfg.family == "encdec":      # the audio frontend's stub
            batch["frames"] = torch.zeros(
                (1, prompt.shape[1], self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        logits, cache = M.prefill_fn(self.cfg, self.params, batch,
                                     cache_len=self.max_len)
        # the single sequence's cache goes into this slot's batch lane: its
        # leading extent only, the rest of the lane keeps what it held (an
        # encoder cache shorter than S_enc leaves a stale tail, caveat R8)
        for name, full in self.caches.items():
            one = cache[name][:, 0]
            lead = tuple(slice(0, n) for n in one.shape[1:])
            full[(slice(None), slot) + lead] = one
        tok = int(torch.argmax(logits[0, -1]))
        self.tokens[slot, 0] = tok
        self.pos[slot] = req.prompt.shape[0]
        self.remaining[slot] = req.max_new
        self.active[slot] = True
        self.rids[slot] = req.rid
        self.results[req.rid] = [tok]

    @torch.inference_mode()
    def run(self, requests: List[Request], greedy: bool = True):
        queue = list(requests)
        served = 0
        steps = 0
        while queue or self.active.any():
            for slot in range(self.n_slots):
                if not self.active[slot] and queue:
                    self._prefill_one(slot, queue.pop(0))
            pos = int(self.pos.max())  # uniform pos approximation
            logits, self.caches = self._decode(self.params, self.caches,
                                               self.tokens, pos)
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            self.tokens = nxt[:, None]
            steps += 1
            nxt = nxt.tolist()
            for slot in range(self.n_slots):
                if not self.active[slot]:
                    continue
                self.results[self.rids[slot]].append(nxt[slot])
                self.pos[slot] += 1
                self.remaining[slot] -= 1
                if self.remaining[slot] <= 0 or self.pos[slot] >= \
                        self.max_len - 1:
                    self.active[slot] = False
                    served += 1
        return {"served": served, "decode_steps": steps,
                "results": self.results}


def main(argv=None) -> dict:
    """Serve ``--requests`` random prompts of the smoke model of
    ``--arch`` (weights from seed 0) and print one summary line. Returns
    the server's result (``served``, ``decode_steps``, ``results``: each
    request's token stream) with ``tokens`` and ``seconds``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke_model()
    params = M.init_params(cfg, seed=0, device=args.device)
    server = Server(cfg, params, n_slots=args.slots, max_len=128,
                    device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len),
                    args.max_new) for i in range(args.requests)]
    t0 = time.time()
    out = server.run(reqs)
    dt = time.time() - t0
    toks = sum(len(v) for v in out["results"].values())
    print(f"[serve] arch={args.arch} served={out['served']} "
          f"decode_steps={out['decode_steps']} tokens={toks} "
          f"({toks / dt:.1f} tok/s) in {dt:.1f}s")
    return dict(out, tokens=toks, seconds=dt)


if __name__ == "__main__":
    main()
