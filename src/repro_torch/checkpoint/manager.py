"""Fault-tolerant checkpointing: one .npy per leaf and a JSON manifest.

Counterpart of ``repro.checkpoint.manager``, with its on-disk contract:
- atomic: written into ``<dir>/tmp-<step>``, then renamed to
  ``step-<step>``;
- async: a save runs on a background thread while training goes on;
  ``wait`` joins it;
- one ``leaf{i}.npy`` per tensor, bf16 stored as float32 (``.npy`` has
  no bf16), and ``manifest.json`` with ``step``, ``n_leaves`` and the
  structure (``treedef``: the leaves' dotted names, comma-joined);
- retention: the latest ``keep`` checkpoints stay;
- under a default process group every rank holds the same state: rank 0
  writes, and every rank meets the others at a barrier once rank 0's
  write is done (at the next ``save``, or in ``wait``). Every rank
  restores.

A state is a tree of dicts with tensor leaves, flattened in the dicts'
insertion order: the trainer's ``{"params": ..., "opt": {"m", "v",
"step"}}`` takes the model's parameter order. The port reads its own
checkpoints, not the reference's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.api import process_group


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a tree of dicts under dotted names, in insertion
    order."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _unflatten(like: Mapping, leaves: Dict[str, torch.Tensor],
               prefix: str = "") -> Dict:
    return {k: _unflatten(v, leaves, f"{prefix}{k}.")
            if isinstance(v, Mapping) else leaves[f"{prefix}{k}"]
            for k, v in like.items()}


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Mapping, blocking: bool = False) -> None:
        """Write ``state`` as ``step-<step>``, on a thread unless
        ``blocking``. Every leaf is copied to the host before this
        returns, so training may go on changing the tensors in place.
        Under a process group only rank 0 writes; every rank must call
        this at the same steps."""
        self.wait()                      # serialize with in-flight saves
        group = process_group()
        if (group is None or group[0] == 0) and step not in self.all_steps():
            self._start(step, state, blocking)
        if blocking:
            self.wait()

    def _start(self, step: int, state: Mapping, blocking: bool) -> None:
        leaves = flatten(state)
        host = []
        for t in leaves.values():
            dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            host.append(t.detach().to("cpu", dtype, copy=True).numpy())
        structure = ",".join(leaves)

        def _write():
            tmp = self.dir / f"tmp-{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            for i, a in enumerate(host):
                np.save(tmp / f"leaf{i}.npy", a)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": structure, "time": time.time()}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step-{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join an in-flight save; under a process group, then wait for
        every rank."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if process_group() is not None:
            dist.barrier()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step-*"):
            try:
                out.append(int(p.name.split("-")[1]))
            except ValueError:
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Mapping) -> Dict:
        """The checkpoint ``step-<step>`` in the structure of ``like``, as
        CPU tensors cast back to each ``like`` leaf's dtype (the caller
        copies them where they belong). Raises if the structure changed."""
        d = self.dir / f"step-{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = flatten(like)
        if manifest["n_leaves"] != len(leaves) or \
                manifest["treedef"] != ",".join(leaves):
            raise ValueError(f"checkpoint {d} holds another tree structure")
        out = {}
        for i, (name, ref) in enumerate(leaves.items()):
            t = torch.from_numpy(np.load(d / f"leaf{i}.npy"))
            out[name] = t.to(ref.dtype)   # cast back (e.g. f32 -> bf16)
        return _unflatten(like, out)
