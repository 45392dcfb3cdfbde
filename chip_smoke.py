"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels from the sources in this checkout, holds each against its plain
torch version on the card, drives the route-and-simulate main path at
full size (PT 8x8x8 and the synthesized TONS_SYM 256 fabric), checks the
simulator's CUDA and CPU runs agree, and prints one JSON line per result.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and the repository's
``src/`` and ``benchmarks/results/`` beside this file. Imports nothing
of JAX or of the JAX package ``repro``. The last line of the output is
``{"ok": true, "device": {...}}``; any failed phase exits non-zero first.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM memory rate (HBM3).
PEAK_BYTES = 3.35e12
FP32_LANES_PER_SM = 128


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def minplus_bound_ms(M: int, K: int, N: int, ops_per_s: float) -> tuple:
    """Least time for one (min,+) product: M*N*K adds and M*N*K mins,
    which do not fuse, at one FP32 instruction per lane per clock
    (``ops_per_s``), or each operand read once and the result written
    once at the memory rate; the larger, and which one it is."""
    t_ops = 2.0 * M * N * K / ops_per_s * 1e3
    t_bytes = 4.0 * (M * K + K * N + M * N) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(mp, ops, ref, PT, tons, ops_per_s):
    """Every kernel shape against the plain version, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(M, K, N):
        return (torch.rand(M, K, device=dev, generator=g) * 10,
                torch.rand(K, N, device=dev, generator=g) * 10)

    # the main path's inputs: the hop matrices of PT 8^3 (512^3 products)
    # and TONS_SYM 256 (256^3), and their partial closures; PT 8x8x16's
    # closure for ragged blocks; random f32 at every shape, and a shape
    # with ragged edges on every side
    pt8 = ops.hop_matrix(PT.pt((8, 8, 8)).edges(), 512, dev)
    t256 = ops.hop_matrix(tons.edges(), tons.n, dev)
    closure = ref.apsp_ref(ops.hop_matrix(PT.pt((8, 8, 16)).edges(), 1024,
                                          dev))

    def partial(d, squarings):
        for _ in range(squarings):
            d = ref.minplus_ref(d, d)
        return d

    cases = [
        ((128, 128, 128), "random", *rand(128, 128, 128)),
        ((128, 128, 128), "hops", pt8[:128, :128].contiguous(),
         pt8[:128, :128].contiguous()),
        ((512, 512, 512), "random", *rand(512, 512, 512)),
        ((512, 512, 512), "hops", pt8, partial(pt8, 3)),
        ((256, 256, 256), "random", *rand(256, 256, 256)),
        ((256, 256, 256), "hops", t256, partial(t256, 3)),
        ((1024, 256, 512), "random", *rand(1024, 256, 512)),
        ((1024, 256, 512), "hops", closure[:, :256].contiguous(),
         closure[:256, :512].contiguous()),
        ((100, 70, 130), "random", *rand(100, 70, 130)),
    ]
    max_err = 0.0
    for (M, K, N), kind, x, y in cases:
        got = mp.minplus(x, y)
        torch.cuda.synchronize()
        want = ref.minplus_ref(x, y)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"minplus {kind} {(M, K, N)} differs, max err {err}")
        emit(phase="minplus_parity", shape=[M, K, N], input=kind,
             exact=True, max_abs_err=err)

    # the main path's APSP of each fabric equals the host BFS
    for name, topo in (("PT 8x8x8", PT.pt((8, 8, 8))), ("TONS_SYM 256", tons)):
        check(np.array_equal(PT.bfs_all_pairs(topo, device=dev),
                             PT.bfs_all_pairs(topo,
                                              sources=np.arange(topo.n))),
              f"{name} APSP differs from host BFS")
        emit(phase="apsp_parity", fabric=name, n=topo.n,
             equal_to_host_bfs=True)

    # main-path shapes, timed on the main path's own hop matrices
    rows = {}
    for n, d in ((512, pt8), (256, t256)):
        ms = cuda_ms(lambda: mp.minplus(d, d), 50)
        plain_ms = cuda_ms(lambda: ref.minplus_ref(d, d), 5)
        bound, by = minplus_bound_ms(n, n, n, ops_per_s)
        rows[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by)
        emit(phase="minplus_time", shape=[n, n, n], ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    # the full TPU v4 pod: PT 16^3, n = 4096, 12 squarings
    topo = PT.pt((16, 16, 16))
    t0 = time.perf_counter()
    d_dev = PT.bfs_all_pairs(topo, device=dev)
    torch.cuda.synchronize()
    t_apsp = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_host = PT.bfs_all_pairs(topo, sources=np.arange(topo.n))
    t_bfs = time.perf_counter() - t0
    check(np.array_equal(d_dev, d_host), "16^3 APSP differs from host BFS")
    diam, avg = ops.topology_metrics(topo.edges(), topo.n, device=dev)
    fin = d_host[np.isfinite(d_host)]
    check(diam == int(fin.max()), "16^3 diameter differs from host BFS")
    d0 = ops.hop_matrix(topo.edges(), topo.n, dev)
    ms = cuda_ms(lambda: mp.minplus(d0, d0), 5)
    plain_ms = cuda_ms(lambda: ref.minplus_ref(d0, d0), 1)
    bound, by = minplus_bound_ms(4096, 4096, 4096, ops_per_s)
    emit(phase="apsp_16x16x16", n=topo.n, equal_to_host_bfs=True,
         diameter=diam, avg_hops=avg, squarings=int(math.ceil(
             math.log2(topo.n - 1))), apsp_s=t_apsp, host_bfs_s=t_bfs,
         ms_per_squaring=ms, plain_ms_per_squaring=plain_ms,
         bound_ms=bound, bound_by=by)
    rows[4096] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by=by)
    return rows, max_err


def drive(name, topo, PNS, route_pod):
    """route_pod + saturation_point at the defaults, on the card."""
    t0 = time.perf_counter()
    rp = route_pod(topo, device="cuda")
    t_route = time.perf_counter() - t0
    check(rp.unreachable == 0, f"{name}: unreachable pairs")
    stats: dict = {}
    t0 = time.perf_counter()
    sat, trace = PNS.saturation_point(rp.tables, stats=stats,
                                      device="cuda")
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    for r in trace:
        check(r["injected_total"] == r["consumed_total"] + r["in_flight"],
              f"{name}: conservation fails at rate {r['rate']}")
        check(r["delivered_tagged"] <= r["accepted"] <= r["offered"]
              + 1e-12, f"{name}: accounting order at rate {r['rate']}")
    check(0.0 < sat <= 1.0, f"{name}: saturation {sat}")
    emit(phase="main_path", fabric=name, n=topo.n, saturation=sat,
         route_s=t_route, sweep_s=t_sweep, l_max=rp.l_max,
         route_timings=rp.timings, sim_cycles=stats["sim_cycles"],
         lane_cycles=stats["lane_cycles"],
         sim_cycles_per_s=stats["sim_cycles"] / t_sweep,
         lane_cycles_per_s=stats["lane_cycles"] / t_sweep,
         trace_rates=[r["rate"] for r in trace], conservation=True)
    return rp


def busy_share(PNS, tables, rates, cycles: int) -> dict:
    """Device busy share of a sweep: the union of its CUDA kernels' time
    intervals in a profiler trace, over the sweep's host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    PNS.sweep(tables, rates, cycles=cycles, warmup=cycles // 2,
              device="cuda")                                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PNS.sweep(tables, rates, cycles=cycles, warmup=cycles // 2,
                  device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(wall_s=wall, device_busy_s=busy / 1e6,
                busy_share=busy / 1e6 / wall, kernels=len(spans),
                kernels_per_cycle=len(spans) / cycles)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch.core import netsim as PNS, topology as PT
    from repro_torch.core.pipeline import route_pod
    from repro_torch.kernels import minplus as mp, ops, ref

    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # one FP32 instruction per lane per clock: (min,+) has no FMA, so this
    # is half the published FP32 FLOP/s, which counts an FMA as two
    ops_per_s = sm_clock_hz * sms * FP32_LANES_PER_SM
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=card, max_sm_clock_mhz=sm_clock_hz / 1e6, sms=sms,
         fp32_instr_per_s=ops_per_s)
    print(card, flush=True)

    t0 = time.perf_counter()
    mp.library()
    emit(phase="build", kernel="minplus", seconds=time.perf_counter() - t0,
         nvcc_seconds=mp.build_seconds)

    tons = convert.load_fabric(
        ROOT / "benchmarks" / "results" / "tons_256.pkl", (4, 8, 8),
        name="TONS_SYM 256")
    rows, max_err = phase_kernels(mp, ops, ref, PT, tons, ops_per_s)

    # ---- the main path, counts from zero -----------------------------------
    mp.launches = 0
    rp8 = drive("PT 8x8x8", PT.pt((8, 8, 8)), PNS, route_pod)
    launches_8 = mp.launches
    drive("TONS_SYM 256", tons, PNS, route_pod)
    launches = mp.launches
    emit(phase="launches", minplus_after_pt8=launches_8,
         minplus_main_path=launches)
    check(launches_8 > 0, "route_pod(PT 8^3) never launched minplus")
    check(launches > launches_8, "TONS_SYM 256 never launched minplus")

    # ---- where a sweep's time goes: device busy share under the profiler ----
    emit(phase="sweep_profile", fabric="PT 8x8x8", lanes=10, cycles=512,
         **busy_share(PNS, rp8.tables, [0.03 * (i + 1) for i in range(10)],
                      512))

    # ---- the simulator is deterministic across devices ---------------------
    rp = route_pod(PT.pt((4, 4, 8)), device="cuda")
    rates = [0.02, 0.08, 0.2, 0.6]
    on_gpu = PNS.sweep(rp.tables, rates, cycles=1200, warmup=400,
                       device="cuda")
    on_cpu = PNS.sweep(rp.tables, rates, cycles=1200, warmup=400,
                       device="cpu")
    check(on_gpu == on_cpu, "CUDA and CPU sweeps differ at 4x4x8")
    emit(phase="device_determinism", fabric="PT 4x4x8", rates=rates,
         cycles=1200, equal=True)

    k = rows[512]
    print(json.dumps({"kernels": [{
        "name": "minplus", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:24",
        "launches": launches, "parity": "exact", "max_abs_err": max_err,
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
