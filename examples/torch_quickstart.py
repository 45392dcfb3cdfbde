"""Quickstart on the PyTorch port: synthesize a TONS topology, route it
deadlock-free, and compare its throughput proxy against the production
torus baselines. The counterpart of ``quickstart.py``, with the same
calls into ``repro_torch``; the route's all-pairs hop distances run on
the hand-written (min,+) kernel on the GPU. HiGHS solves the LPs on the
host, as in the counterpart.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import synthesis as SY, topology as T  # noqa: E402
from repro_torch.core.mcf import mcf_topology, mcf_uniform  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig, route_pod  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def run(spec=(4, 4, 8), device=None) -> dict:
    """The walkthrough on a pod of ``spec`` chips; returns what it
    printed: the three MCF values, the synthesized fabric's optical
    circuits and its route (pairs routed, ``l_max``, VC hop counts)."""
    device = resolve_device(device)
    print("== baselines ==")
    pt = T.pt(spec)
    lam_pt, _ = mcf_uniform(pt.edges(), pt.n,
                            perms=T.torus_translations(pt.pod),
                            prefer="highs")
    pdtt = T.pdtt(spec)
    lam_pdtt, _ = mcf_uniform(
        pdtt.edges(), pdtt.n,
        perms=T.torus_translations(pdtt.pod, twisted=True), prefer="highs")
    print(f"PT   {spec}: MCF = {lam_pt:.5f}")
    print(f"PDTT {spec}: MCF = {lam_pdtt:.5f}")

    print("== TONS synthesis (Algorithm 3, symmetric, interval=4) ==")
    res = SY.synthesize(spec, symmetric=True, interval=4, verbose=True,
                        device=device)
    lam = mcf_topology(res.topology, prefer="highs")
    print(f"TONS {spec}: MCF = {lam:.5f} "
          f"({lam / lam_pt:.2f}x PT, {lam / lam_pdtt:.2f}x PDTT)")

    print("== deadlock-free routing within 2 VCs ==")
    rp = route_pod(res.topology, PipelineConfig(
        robust=True, K=4, engine="array", local_search_rounds=3,
        vc="inplace", verify=True), device=device)
    assert rp.deadlock_free
    print(f"all {rp.table.n_routed()} pairs routed; "
          f"L_max={rp.l_max:.0f} "
          f"(MCF bound {1 / lam:.0f}); "
          f"VC hop balance={rp.vc_counts.tolist()}")
    return {"spec": tuple(spec), "mcf_pt": lam_pt, "mcf_pdtt": lam_pdtt,
            "mcf_tons": lam, "optical": list(res.topology.optical),
            "n_routed": int(rp.table.n_routed()), "l_max": rp.l_max,
            "vc_counts": rp.vc_counts.tolist(),
            "deadlock_free": bool(rp.deadlock_free)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    # 128 chips = 2 cubes: the smallest interesting pod
    return run((4, 4, 8), device=args.device)


if __name__ == "__main__":
    main()
