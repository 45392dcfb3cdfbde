"""Fault-tolerant pod walkthrough on the PyTorch port: synthesize with
the C8 fault budget, build robust routing, knock out an OCS, and show
the job keeps running -- the network-level story (TONS robust routing)
plus the framework-level story (checkpoint restore after a preemption).
The counterpart of ``fault_tolerant_pod.py``, with the same calls into
``repro_torch``: on the GPU the routes' hop distances run on the
(min,+) kernel, the simulator and the training on the card.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_pod.py [--device cpu]
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.core import fault as F, topology as T  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig, route_pod  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

FABRIC = Path(__file__).parent.parent / "benchmarks/results/tons_128.pkl"


def network(device=None) -> dict:
    """The network side: the certificate, an OCS fault re-routed cold and
    repaired online, and the degraded fabric simulated under four traffic
    patterns. Returns what it printed."""
    device = resolve_device(device)
    print("== robust TONS fabric under a single-OCS fault ==")
    if FABRIC.exists():
        import pickle
        with open(FABRIC, "rb") as f:
            d = pickle.load(f)
        topo = convert.topology_from_arrays((4, 4, 8), d["optical"],
                                            name="TONS 128")
        lam = d["mcf"]
    else:
        topo = T.pdtt((4, 4, 8))
        lam = 0.01364
    cert = F.fault_tolerance_certificate(topo, lam, f=1)
    print(f"C8 certificate: lambda={lam:.5f} >= "
          f"{cert['required_lambda']:.5f} -> up to "
          f"{cert['certified_f']} OCS faults tolerable "
          f"(color budget {cert['color_budget']})")

    cfg = PipelineConfig(robust=True, K=4, engine="array",
                         local_search_rounds=2, vc="none")
    rp = route_pod(topo, cfg, device=device)
    at, base = rp.at, rp.routed
    print(f"no fault: all pairs routed, L_max={base.l_max:.0f}")

    colors = F.colors_in_use(topo)
    fault = colors[len(colors) // 2]
    dead = F.dead_channels_for_color(at, fault)
    routed = route_pod(topo, cfg, at=at, dead_channels=dead,
                       device=device).routed
    print(f"OCS {fault} failed ({len(dead)} channels dead): "
          f"unreachable={routed.unreachable}, L_max={routed.l_max:.0f} "
          f"({routed.l_max / base.l_max:.2f}x degradation)")
    assert routed.unreachable == 0

    # online repair: the serving fabric patches itself instead of
    # recomputing -- only the flows crossing dead channels re-route
    from repro_torch.core.repair import ServingState, repair_fault
    t0 = time.time()
    st = ServingState.build(topo, n_vc=2, K=4, robust=True, device=device)
    t_build = time.time() - t0
    t0 = time.time()
    rr = repair_fault(st, dead)
    t_rep = time.time() - t0
    assert rr.unreachable == 0 and rr.deadlock_free
    print(f"online repair: {rr.flows_rerouted} of "
          f"{st.table.n_flows} flows re-routed in {t_rep:.2f}s "
          f"(cold build {t_build:.1f}s, "
          f"{t_build / max(t_rep, 1e-9):.0f}x), "
          f"L_max={rr.l_max:.0f}, deadlock-free")

    # simulate the degraded fabric under several traffic patterns: one
    # simulator serves them all, only the alias tables change
    from repro_torch.core import netsim as NS
    from repro_torch.core.demand import WorkloadDemand
    from repro_torch.core.traffic import TrafficPattern
    tab = NS.at_tables(topo, at, routed)
    wd = WorkloadDemand(topo.pod, w_same_cube=2.0, w_ring=2.0,
                        w_uniform=0.25)
    patterns = [TrafficPattern.uniform(topo.n),
                TrafficPattern.transpose(topo.pod),
                TrafficPattern.hotspot(topo.n, [0, 1, 2, 3], 0.4),
                TrafficPattern.from_demand(wd)]
    sims = {}
    for pat in patterns:
        r = NS.run(tab, 0.05, traffic=pat, cycles=1200, warmup=400,
                   device=device)
        print(f"  {pat.name:10s}: delivered {r['delivered']:.4f} "
              f"of offered {r['offered']:.4f} under the fault")
        sims[pat.name] = (r["delivered"], r["offered"])
    return {"lambda": lam, "certificate": cert, "fault_color": fault,
            "dead_channels": len(dead), "unreachable": routed.unreachable,
            "l_max_base": base.l_max, "l_max_fault": routed.l_max,
            "flows_rerouted": rr.flows_rerouted,
            "n_flows": st.table.n_flows, "l_max_repair": rr.l_max,
            "repair_s": t_rep, "build_s": t_build, "sims": sims}


def training(device=None) -> dict:
    """The framework side: the smoke model trains 6 steps with a
    checkpoint every 3, then a fresh trainer resumes and ends at step 8.
    Returns the start and final steps and both runs' losses."""
    device = resolve_device(device)
    print("== training survives preemption via checkpoint restore ==")
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config("qwen2.5-3b").smoke_model()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(steps=6, ckpt_every=3, ckpt_dir=d, log_every=3)
        t1 = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4),
                     OptConfig(total_steps=6), tc, device=device)
        first = t1.run()
        # "preemption": a fresh process picks up from the last checkpoint
        t2 = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4),
                     OptConfig(total_steps=6),
                     TrainConfig(steps=8, ckpt_every=3, ckpt_dir=d,
                                 log_every=3), device=device)
        print(f"restarted at step {t2.start_step}")
        out = t2.run()
        assert out["final_step"] == 8
    return {"start_step": t2.start_step, "final_step": out["final_step"],
            "losses": first["losses"], "resumed_losses": out["losses"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = network(device)
    out.update(training(device))
    print("ok: fabric re-routed and training resumed")
    return out


if __name__ == "__main__":
    main()
