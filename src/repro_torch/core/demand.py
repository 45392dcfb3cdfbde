"""Workload traffic matrices on the pod graph (framework <-> TONS bridge,
and the beyond-paper weighted-demand synthesis).

The paper optimizes uniform all-to-all. Real training steps have a *mix*:
DP all-reduce over the data axis, TP/EP collectives within model groups,
MoE token all-to-all. We map the mesh onto the pod with the natural TPU
assignment -- the "model" axis lives inside a cube (fast electrical mesh),
the "data" axis spans cubes -- and derive pairwise demand weights from the
dry-run's measured per-collective wire bytes. These weights are invariant
under cube translations (same-cube membership and cube-offset rings), so
the symmetric synthesis reductions still apply.

Port of ``repro.core.demand``: host numpy, unchanged except that
:func:`weighted_mcf` passes ``device`` on to the LP (HiGHS solves it;
only a failed HiGHS solve falls through to PDHG on the device).
:func:`from_dryrun` reads the JSON files the reference's
``launch/dryrun.py`` writes; the port never writes them.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict

import numpy as np

from repro_torch.core.topology import CUBE, Pod


@dataclasses.dataclass
class WorkloadDemand:
    """Pairwise weights: w_same_cube (TP/EP all-to-all within a cube) and
    w_ring (DP all-reduce ring across cubes at the same in-cube slot) and
    w_uniform (background)."""
    pod: Pod
    w_same_cube: float = 0.0
    w_ring: float = 0.0
    w_uniform: float = 1.0

    def weight_fn(self) -> Callable:
        pod = self.pod
        X, Y, Z = pod.dims
        cx, cy, cz = pod.cube_dims
        n_c = pod.n_cubes

        def cube_idx(i):
            x, y, z = i % X, (i // X) % Y, i // (X * Y)
            return (x // CUBE) + cx * ((y // CUBE) + cy * (z // CUBE))

        def incube(i):
            x, y, z = i % X, (i // X) % Y, i // (X * Y)
            return (x % CUBE) + CUBE * ((y % CUBE) + CUBE * (z % CUBE))

        ws, wr, wu = self.w_same_cube, self.w_ring, self.w_uniform

        def fn(a, b):
            a = np.asarray(a, np.int64)
            b = np.asarray(b, np.int64)
            ca = np.array([cube_idx(int(x)) for x in a.ravel()])
            cb = np.array([cube_idx(int(x)) for x in b.ravel()])
            ia = np.array([incube(int(x)) for x in a.ravel()])
            ib = np.array([incube(int(x)) for x in b.ravel()])
            w = np.full(a.size, wu, np.float64)
            w = np.where(ca == cb, w + ws, w)
            # ring neighbours: same in-cube slot, adjacent cube index.
            # (Translation-invariant for the <=4-cube pods we synthesise.)
            adj = (np.abs(ca - cb) == 1) | (np.abs(ca - cb) == n_c - 1)
            w = np.where((ia == ib) & adj & (ca != cb), w + wr, w)
            return w.reshape(a.shape)

        return fn

    def matrix(self) -> np.ndarray:
        """Dense (n, n) pairwise weights with zero diagonal -- the bridge
        into the simulator's TrafficPattern (repro_torch.core.traffic)."""
        n = self.pod.n
        idx = np.arange(n)
        a = np.repeat(idx, n)
        b = np.tile(idx, n)
        w = self.weight_fn()(a, b).reshape(n, n)
        np.fill_diagonal(w, 0.0)
        return w


def from_mix(pod: Pod, wires: Dict[str, float]) -> WorkloadDemand:
    """Per-collective wire-byte mix -> pairwise weight levels.

    The single mapping shared by the dry-run reader below and the
    analytic estimator in :mod:`repro_torch.core.workload`: MoE/EP
    all-to-all bytes load the same-cube weight (the model axis lives
    inside a cube), ring-style collectives (all-reduce,
    reduce-scatter, all-gather) load the cross-cube DP ring, and a
    uniform floor keeps every pair connected-by-demand.
    """
    a2a = wires.get("all-to-all", 0.0)
    ar = wires.get("all-reduce", 0.0) + wires.get("reduce-scatter", 0.0) \
        + wires.get("all-gather", 0.0)
    total = a2a + ar
    if total <= 0:
        return WorkloadDemand(pod)
    return WorkloadDemand(pod, w_same_cube=4.0 * a2a / total,
                          w_ring=4.0 * ar / total, w_uniform=0.25)


def from_dryrun(podspec, arch: str, shape: str,
                dryrun_dir: str = "benchmarks/results/dryrun",
                mesh: str = "single_pod_16x16") -> WorkloadDemand:
    """Build demand weights from a dry-run cell's measured collectives."""
    pod = Pod(podspec)
    f = Path(dryrun_dir) / f"{arch}__{shape}__{mesh}.json"
    if not f.exists():
        return WorkloadDemand(pod)
    d = json.loads(f.read_text())
    coll = d.get("collectives", {})
    wires = {k: v.get("wire_bytes", 0.0) for k, v in coll.items()}
    return from_mix(pod, wires)


def weighted_mcf(topo, demand: WorkloadDemand, perms=None,
                 prefer: str = "highs", device=None) -> float:
    from repro_torch.core.mcf import mcf_uniform
    from repro_torch.core.topology import cube_translations
    if perms is None:
        perms = cube_translations(topo.pod)
    lam, _ = mcf_uniform(topo.edges(), topo.n, perms=perms, prefer=prefer,
                         pair_weight=demand.weight_fn(), device=device)
    return lam
