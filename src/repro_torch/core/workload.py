"""Workload co-design: parallelization-derived demand -> specialized TONS.

The generic synthesis LP maximises a uniform all-to-all throughput
proxy; TopoOpt and ACOS (PAPERS.md) show the real win comes from
co-optimising the fabric with the *training job*. This module closes
that loop end to end:

1. :func:`collective_mix` -- an analytic per-collective wire-byte
   estimate straight from a :class:`~repro_torch.configs.base.ModelConfig` +
   :class:`~repro_torch.configs.base.ShapeConfig` (DP gradient all-reduce, TP
   activation all-gather/reduce-scatter, MoE token all-to-all), used
   whenever no measured dry-run JSON exists on disk;
2. :func:`workload_demand` -- dry-run measurements when available
   (:func:`repro_torch.core.demand.from_dryrun`), the analytic mix otherwise,
   both through the same :func:`repro_torch.core.demand.from_mix` mapping, so
   the two sources are interchangeable;
3. :func:`synthesize_for_workload` -- the demand's translation-invariant
   ``weight_fn`` becomes ``pair_weight`` for the symmetric synthesis LP:
   a fabric optimised for *this* job's traffic;
4. :func:`replay_trace` -- the workload's one-step collective sequence
   as a :class:`~repro_torch.core.traffic.PhasedTraffic` (in-cube TP/EP
   all-to-all phase -> cross-cube DP-ring phase -> uniform background,
   durations proportional to wire bytes) for the simulator's
   trace-replay mode;
5. :func:`evaluate_workload` -- demand-weighted MCF + trace-replay
   saturation of any topology on a workload, routed through
   :func:`repro_torch.core.pipeline.route_pod` (the headline
   specialized-vs-generic-vs-torus comparison in bench_workload / fig11);
6. :func:`workload_tenant` -- a sub-pod slice of a workload's demand as
   a :class:`~repro_torch.core.traffic.TenantSpec` for multi-job composition.

MoE archs come out all-to-all-heavy (same-cube demand), dense archs
all-reduce-heavy (cross-cube DP rings) -- so their specialized fabrics
genuinely differ, which is the point.

Port of ``repro.core.workload``: host numpy on the port's configs,
demand and traffic, unchanged except that :func:`evaluate_workload`
routes (APL priorities on the (min,+) APSP kernel) and simulates on
``device``, and :func:`synthesize_for_workload` passes ``device`` on to
the synthesis LP through ``synth_kw``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.core import demand
from repro_torch.core.demand import WorkloadDemand, weighted_mcf
from repro_torch.core.pipeline import PipelineConfig, route_pod
from repro_torch.core.topology import Pod
from repro_torch.core.traffic import PhasedTraffic, TenantSpec, TrafficPattern
from repro_torch.device import resolve_device

_BF16 = 2.0     # bytes per element on the wire


def collective_mix(model: ModelConfig, shape: ShapeConfig
                   ) -> Dict[str, float]:
    """Analytic per-collective wire-byte estimate for one step.

    Deliberately coarse -- it only needs to get the *ratios* right for
    the demand-weight mapping (:func:`repro_torch.core.demand.from_mix`
    normalises to relative levels):

    - TP activation collectives: one all-gather + one reduce-scatter of
      the token activations per layer's mixer/FFN pair;
    - MoE dispatch + combine: ``top_k``-way token all-to-all, twice per
      MoE layer;
    - DP gradient sync (train shapes only): ring all-reduce over the
      parameters, ~2x param bytes on the wire.

    Decode shapes process one new token per step, so token-proportional
    terms collapse while the (absent, in decode) gradient term stays 0
    -- the mix degrades gracefully to TP-dominated, which is what a
    decode step actually looks like.
    """
    steps_tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    D = float(model.d_model)
    enc_dec = model.family == "encdec"
    layers = (model.enc_layers + model.dec_layers) if enc_dec \
        else model.n_layers
    n_moe = 0 if enc_dec else sum(
        1 for i in range(layers) if model.ffn_kind(i) == "moe")
    wires = {"all-to-all": 0.0, "all-reduce": 0.0,
             "all-gather": 0.0, "reduce-scatter": 0.0}
    act = steps_tokens * D * _BF16
    wires["all-gather"] += layers * act
    wires["reduce-scatter"] += layers * act
    if n_moe and model.top_k:
        # dispatch + combine, top_k expert copies per token
        wires["all-to-all"] += 2 * n_moe * act * model.top_k
    if shape.kind == "train":
        wires["all-reduce"] += 2 * model.param_count() * _BF16
    return wires


def workload_demand(podspec, arch: str, shape: str = "train_4k",
                    dryrun_dir: str = "benchmarks/results/dryrun",
                    mesh: str = "single_pod_16x16") -> WorkloadDemand:
    """Demand weights for a registered arch on a pod: measured dry-run
    collectives when the JSON exists, the analytic mix otherwise --
    identical mapping either way (:func:`repro_torch.core.demand.from_mix`).
    """
    from pathlib import Path
    f = Path(dryrun_dir) / f"{arch}__{shape}__{mesh}.json"
    if f.exists():
        return demand.from_dryrun(podspec, arch, shape,
                                  dryrun_dir=dryrun_dir, mesh=mesh)
    model = get_config(arch).model
    return demand.from_mix(Pod(podspec),
                           collective_mix(model, get_shape(shape)))


def synthesize_for_workload(podspec, arch: str, shape: str = "train_4k",
                            wd: Optional[WorkloadDemand] = None,
                            **synth_kw):
    """Synthesize a fabric specialized for one workload's demand.

    The demand's ``weight_fn`` (translation-invariant by construction:
    same-cube membership + cube-offset rings) rides into the symmetric
    synthesis LP as ``pair_weight``, so the orbit reductions still
    apply and only the objective changes. Returns
    ``(SynthesisResult, WorkloadDemand)``; extra kwargs forward to
    :func:`repro_torch.core.synthesis.synthesize`.
    """
    from repro_torch.core.synthesis import synthesize
    if wd is None:
        wd = workload_demand(podspec, arch, shape)
    res = synthesize(podspec, symmetric=True, pair_weight=wd.weight_fn(),
                     **synth_kw)
    return res, wd


def replay_trace(wd: WorkloadDemand, period: int = 256,
                 min_cycles: int = 8) -> PhasedTraffic:
    """The workload's one-step collective sequence as a cyclic phased
    demand schedule for the simulator.

    Up to three phases -- in-cube TP/EP all-to-all, cross-cube DP ring,
    uniform background -- each phase's spatial pattern the
    corresponding single-component :class:`WorkloadDemand` matrix, so a
    trace replay stresses the fabric the way the training step does:
    bursts of concentrated collective traffic, not a stationary blend.

    Phase durations are proportional to per-node wire *volume* (demand
    level x partner count, i.e. the component's row mass), floored at
    ``min_cycles`` and summing to ~``period`` cycles: at a fixed
    per-node injection bandwidth, a phase moving k times the bytes
    occupies k times the cycles. (Weight *levels* alone would misprice
    broad components -- a uniform floor touching every pair moves far
    more volume per node than one ring partner at a higher level.)
    Keep ``min_cycles`` small relative to ``period``: it exists only to
    stop a phase degenerating to zero cycles, and a large floor hands
    low-volume phases schedule share their bytes don't justify.
    """
    pod = wd.pod
    comps: List[Tuple[str, WorkloadDemand]] = []
    if wd.w_same_cube > 0:
        comps.append(("a2a", WorkloadDemand(
            pod, w_same_cube=wd.w_same_cube, w_uniform=0.0)))
    if wd.w_ring > 0:
        comps.append(("ring", WorkloadDemand(
            pod, w_ring=wd.w_ring, w_uniform=0.0)))
    comps.append(("background", WorkloadDemand(
        pod, w_uniform=max(float(wd.w_uniform), 1e-6))))
    patterns = []
    masses = []
    for name, d in comps:
        m = d.matrix()
        patterns.append(TrafficPattern.from_matrix(name, m))
        masses.append(float(m.sum()) / pod.n)      # per-node volume
    total = sum(masses)
    cycles = [max(min_cycles, int(round(period * m / total)))
              for m in masses]
    return PhasedTraffic("trace", tuple(patterns), tuple(cycles))


def demand_pair_weight(wd: WorkloadDemand, cap: int = 64) -> np.ndarray:
    """Quantize a demand matrix into the integer multiplicities that
    :func:`repro_torch.core.routing.select_paths` consumes as ``pair_weight``:
    the smallest positive weight maps to 1, heavier pairs to their
    (capped) integer ratio. Zero-weight pairs still route at weight 1
    (every pair keeps a path; only the balance objective changes).
    """
    m = wd.matrix()
    pos = m[m > 0]
    if pos.size == 0:
        return np.ones_like(m)
    return np.clip(np.rint(m / pos.min()), 1, cap)


def evaluate_workload(topo, wd: WorkloadDemand,
                      trace: Optional[PhasedTraffic] = None,
                      cfg: Optional[PipelineConfig] = None,
                      sat_kwargs: Optional[dict] = None,
                      weighted_routing: bool = True, device=None) -> dict:
    """Score one topology on one workload: demand-weighted MCF (exact
    LP) + trace-replay saturation (simulated), via the routing facade.

    ``weighted_routing`` (default) routes with the demand's integer
    pair multiplicities so path selection balances the *workload's*
    channel load, not the uniform proxy -- the co-design applies to
    routing as well as synthesis. It forces the array engine (the
    weighted one); pass ``weighted_routing=False`` to score with the
    demand-blind pipeline exactly as the other benchmarks run it.
    Routing and simulation run on ``device`` (``None`` = CUDA).
    """
    from repro_torch.core.netsim import saturation_point
    device = resolve_device(device)
    out: dict = {"name": topo.name, "n": topo.n}
    out["weighted_mcf"] = float(weighted_mcf(topo, wd, device=device))
    cfg = cfg or PipelineConfig()
    pw = None
    if weighted_routing:
        pw = demand_pair_weight(wd)
        if cfg.engine != "array":
            cfg = dataclasses.replace(cfg, engine="array")
    rp = route_pod(topo, cfg, pair_weight=pw, device=device)
    out["l_max"] = rp.l_max
    sat, _ = saturation_point(rp.tables,
                              traffic=trace or replay_trace(wd),
                              device=device, **(sat_kwargs or {}))
    out["trace_saturation"] = float(sat)
    return out


def workload_tenant(name: str, podspec, nodes: Sequence[int], arch: str,
                    shape: str = "train_4k",
                    rate_share: float = 1.0) -> TenantSpec:
    """One job's sub-pod slice as a tenant: the workload's full-pod
    demand matrix restricted to ``nodes`` (a job placed on a cube keeps
    its in-cube TP/EP weights; a job spanning cubes keeps its rings).
    Compose several with :func:`repro_torch.core.traffic.compose_tenants`.
    """
    wd = workload_demand(podspec, arch, shape)
    nodes = np.asarray(nodes, np.int64)
    sub = wd.matrix()[np.ix_(nodes, nodes)]
    return TenantSpec(name, nodes, sub, rate_share)
