"""The port's workload co-design against the JAX reference (mirrors
test_workload.py and test_demand.py): collective mixes, demand weights,
dry-run files, replay traces and routing multiplicities equal; weighted
MCF within 1e-9 (HiGHS on identical LPs); simulator counters of replay
sweeps, tenants and ``evaluate_workload`` equal (``==``); collective
schedules equal.

The reference simulator calls ``jax.experimental.disable_x64``, which
this JAX release removed (ROADMAP caveat R1); the fixture below patches
it back only while a test runs, never at import time.
"""
import json

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import collectives as C, demand as D, netsim as NS, \
    topology as T, workload as W
from repro.core.pipeline import PipelineConfig as RefConfig, \
    route_pod as ref_route_pod
from repro.core.traffic import compose_tenants as ref_compose
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.core import collectives as PC, demand as PD, \
    netsim as PNS, topology as PT, workload as PW
from repro_torch.core.pipeline import PipelineConfig, route_pod
from repro_torch.core.traffic import TrafficPattern, compose_tenants

MOE_ARCH = "deepseek-moe-16b"
DENSE_ARCH = "gemma-7b"
TOL = 1e-9
SAT = dict(step=0.05, cycles=800, warmup=300)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_netsim(monkeypatch):
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    return NS


def _demand_fields(wd):
    return (wd.pod.dims, wd.w_same_cube, wd.w_ring, wd.w_uniform)


@pytest.mark.parametrize("shape", ["train_4k", "decode"])
def test_collective_mix_equals_reference(shape):
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.registry import get_config as ref_config, \
        get_shape as ref_shape
    if shape == "decode":
        sp = ShapeConfig("decode_1", seq_len=4096, global_batch=64,
                         kind="decode")
        sr = RefShape("decode_1", seq_len=4096, global_batch=64,
                      kind="decode")
    else:
        sp, sr = get_shape(shape), ref_shape(shape)
    for arch in (MOE_ARCH, DENSE_ARCH, "qwen2.5-3b"):
        got = PW.collective_mix(get_config(arch).model, sp)
        assert got == W.collective_mix(ref_config(arch).model, sr), arch
    moe = PW.collective_mix(get_config(MOE_ARCH).model, sp)
    dense = PW.collective_mix(get_config(DENSE_ARCH).model, sp)
    assert dense["all-to-all"] == 0.0 and moe["all-to-all"] > 0
    assert (dense["all-reduce"] > 0) == (shape == "train_4k")


def test_workload_demand_equals_reference():
    for arch in (MOE_ARCH, DENSE_ARCH):
        for spec in ((4, 4, 4), (4, 4, 8)):
            got = PW.workload_demand(spec, arch)
            assert _demand_fields(got) == \
                _demand_fields(W.workload_demand(spec, arch))
    moe = PW.workload_demand((4, 4, 8), MOE_ARCH)
    dense = PW.workload_demand((4, 4, 8), DENSE_ARCH)
    assert moe.w_same_cube > moe.w_ring
    assert dense.w_ring > dense.w_same_cube == 0.0


@pytest.mark.parametrize("arch,heavy", [(MOE_ARCH, "all-to-all"),
                                        (DENSE_ARCH, "all-reduce")])
def test_from_dryrun_json_roundtrip(tmp_path, arch, heavy):
    """A dry-run JSON in the reference's format gives the reference's
    weights, and workload_demand prefers it over the analytic mix."""
    wires = {"all-to-all": 0.0, "all-reduce": 0.0,
             "all-gather": 1e9, "reduce-scatter": 1e9}
    wires[heavy] = 64e9
    (tmp_path / f"{arch}__train_4k__single_pod_16x16.json").write_text(
        json.dumps({"collectives": {
            k: {"wire_bytes": v} for k, v in wires.items()}}))
    got = PD.from_dryrun((4, 4, 8), arch, "train_4k",
                         dryrun_dir=str(tmp_path))
    want = D.from_dryrun((4, 4, 8), arch, "train_4k",
                         dryrun_dir=str(tmp_path))
    assert _demand_fields(got) == _demand_fields(want)
    wd2 = PW.workload_demand((4, 4, 8), arch, dryrun_dir=str(tmp_path))
    assert _demand_fields(wd2) == _demand_fields(got)
    missing = PD.from_dryrun((4, 4, 8), "no-such-arch", "train_4k",
                             dryrun_dir=str(tmp_path))
    assert _demand_fields(missing) == ((4, 4, 8), 0.0, 0.0, 1.0)


def test_weight_fn_and_matrix_equal_reference():
    pod = PT.Pod((4, 4, 8))
    wd = PD.WorkloadDemand(pod, w_same_cube=2.0, w_ring=3.0, w_uniform=0.5)
    ref = D.WorkloadDemand(T.Pod((4, 4, 8)), w_same_cube=2.0, w_ring=3.0,
                           w_uniform=0.5)
    m = wd.matrix()
    assert np.array_equal(m, ref.matrix())
    np.testing.assert_allclose(m, m.T)
    perms = PT.cube_translations(pod)
    rng = np.random.default_rng(0)
    a = rng.integers(0, pod.n, 40)
    b = rng.integers(0, pod.n, 40)
    w0 = wd.weight_fn()(a, b)
    for g in range(len(perms)):
        assert np.array_equal(wd.weight_fn()(perms[g][a], perms[g][b]), w0)


def test_from_mix_equals_reference():
    pod, rpod = PT.Pod((4, 4, 8)), T.Pod((4, 4, 8))
    for wires in ({}, {"all-to-all": 3.0, "all-gather": 1.0},
                  {"all-reduce": 5.0, "reduce-scatter": 2.0}):
        assert _demand_fields(PD.from_mix(pod, wires)) == \
            _demand_fields(D.from_mix(rpod, wires))


def test_weighted_mcf_equals_reference():
    """Uniform weights scale the uniform MCF; a ring-heavy demand shrinks
    the PDTT/PT gap; zero-uniform demand stays finite; each value is the
    reference's."""
    cases = [(PD.WorkloadDemand(PT.Pod((4, 4, 8)), 0.0, 0.0, 2.0), "pt"),
             (PD.WorkloadDemand(PT.Pod((4, 4, 8)), 0.2, 4.0, 0.2), "pt"),
             (PD.WorkloadDemand(PT.Pod((4, 4, 8)), 0.2, 4.0, 0.2), "pdtt"),
             (PD.WorkloadDemand(PT.Pod((4, 4, 8)), 4.0, 0.0, 0.0), "pt")]
    lams = []
    for wd, kind in cases:
        topo = (PT.pdtt if kind == "pdtt" else PT.pt)((4, 4, 8))
        perms = PT.torus_translations(topo.pod, twisted=kind == "pdtt")
        lam = PD.weighted_mcf(topo, wd, perms=perms)
        ref = D.WorkloadDemand(T.Pod((4, 4, 8)), wd.w_same_cube, wd.w_ring,
                               wd.w_uniform)
        want = D.weighted_mcf((T.pdtt if kind == "pdtt" else T.pt)(
            (4, 4, 8)), ref, perms=perms)
        assert abs(lam - want) <= TOL
        lams.append(lam)
    assert abs(lams[0] - 0.0078125 / 2.0) < 1e-6
    assert lams[2] / lams[1] < 0.01364 / 0.0078125
    assert np.isfinite(lams[3]) and lams[3] > 0


def test_zero_uniform_demand_still_routes():
    wd = PD.WorkloadDemand(PT.Pod((4, 4, 8)), w_same_cube=4.0, w_ring=0.0,
                           w_uniform=0.0)
    probs = TrafficPattern.from_demand(wd).compiled().row_probs()
    assert (probs.sum(axis=1) > 0).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    assert probs[0, -1] == 0.0


def test_pair_weight_and_replay_trace_equal_reference():
    for arch in (MOE_ARCH, DENSE_ARCH):
        wd = PW.workload_demand((4, 4, 8), arch)
        ref = W.workload_demand((4, 4, 8), arch)
        pw = PW.demand_pair_weight(wd, cap=64)
        assert np.array_equal(pw, W.demand_pair_weight(ref, cap=64))
        assert pw.min() == 1.0 and pw.max() <= 64.0
        for period in (96, 256):
            tr = PW.replay_trace(wd, period=period)
            rt = W.replay_trace(ref, period=period)
            assert tr.name == rt.name and tr.cycles == rt.cycles
            assert [p.name for p in tr.patterns] == \
                [p.name for p in rt.patterns]
            for p, q in zip(tr.patterns, rt.patterns):
                assert np.array_equal(p.matrix, q.matrix)
    by_name = dict(zip([p.name for p in tr.patterns], tr.cycles))
    assert by_name["background"] > by_name["ring"]


@pytest.fixture(scope="module")
def pods_444():
    """The port's and the reference's routed PT 4^3 at the reference's
    workload-test config."""
    kw = dict(K=4, local_search_rounds=1, engine="sharded")
    rp = route_pod(PT.pt((4, 4, 4)), PipelineConfig(**kw), device="cpu")
    rr = ref_route_pod(T.pt((4, 4, 4)), RefConfig(**kw))
    return rp, rr


def test_replay_and_tenant_sweeps_equal_reference(pods_444, ref_netsim):
    rp, rr = pods_444
    assert np.array_equal(rp.routed.loads, rr.routed.loads)
    wd = PD.WorkloadDemand(rp.topo.pod, 3.0, 1.0, 0.25)
    ref_wd = D.WorkloadDemand(T.Pod((4, 4, 4)), 3.0, 1.0, 0.25)
    kw = dict(cycles=900, warmup=300)
    got = PNS.sweep(rp.tables, [0.1, 0.4],
                    traffic=PW.replay_trace(wd, period=96), device="cpu",
                    **kw)
    want = ref_netsim.sweep(rr.tables, [0.1, 0.4],
                            traffic=W.replay_trace(ref_wd, period=96), **kw)
    assert got == want
    ten = [PW.workload_tenant("moe", (4, 4, 4), range(32), MOE_ARCH),
           PW.workload_tenant("dense", (4, 4, 4), range(32, 64), DENSE_ARCH,
                              rate_share=0.5)]
    rten = [W.workload_tenant("moe", (4, 4, 4), range(32), MOE_ARCH),
            W.workload_tenant("dense", (4, 4, 4), range(32, 64), DENSE_ARCH,
                              rate_share=0.5)]
    assert all(np.array_equal(a.matrix, b.matrix) and
               np.array_equal(a.nodes, b.nodes) for a, b in zip(ten, rten))
    got = PNS.sweep(rp.tables, [0.1], traffic=compose_tenants(64, ten),
                    device="cpu", cycles=600, warmup=200)
    want = ref_netsim.sweep(rr.tables, [0.1],
                            traffic=ref_compose(64, rten), cycles=600,
                            warmup=200)
    assert got == want
    for t in got[0]["tenants"].values():
        assert t["injected"] == t["consumed"] + t["in_flight"] > 0


@pytest.mark.parametrize("arch", [MOE_ARCH, DENSE_ARCH])
def test_evaluate_workload_equals_reference(arch, ref_netsim):
    """Weighted MCF, l_max under demand-weighted routing (array engine)
    and the trace-replay saturation of PT 4^3: the reference's."""
    cfg = dict(K=4, local_search_rounds=1)
    wd = PW.workload_demand((4, 4, 4), arch)
    got = PW.evaluate_workload(PT.pt((4, 4, 4)), wd,
                               cfg=PipelineConfig(**cfg), sat_kwargs=SAT,
                               device="cpu")
    want = W.evaluate_workload(T.pt((4, 4, 4)),
                               W.workload_demand((4, 4, 4), arch),
                               cfg=RefConfig(**cfg), sat_kwargs=SAT)
    assert got["name"] == want["name"] and got["n"] == want["n"]
    assert abs(got["weighted_mcf"] - want["weighted_mcf"]) <= TOL
    assert got["l_max"] == want["l_max"]
    assert got["trace_saturation"] == want["trace_saturation"] > 0


def test_evaluate_workload_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = PW.workload_demand((4, 4, 4), MOE_ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        PW.evaluate_workload(PT.pt((4, 4, 4)), wd, sat_kwargs=SAT)


def test_collective_schedules_equal_reference(pods_444):
    rp, rr = pods_444
    ptopo, rtopo = rp.topo, rr.topo
    for fn in ("all_gather", "all_reduce"):
        got, want = getattr(PC, fn)(ptopo), getattr(C, fn)(rtopo)
        assert (got.kind, got.epochs, got.transmissions, got.n_channels,
                got.ideal_epochs) == (want.kind, want.epochs,
                                      want.transmissions, want.n_channels,
                                      want.ideal_epochs)
    loads, trees = PC.broadcast_trees(ptopo)
    rloads, rtrees = C.broadcast_trees(rtopo)
    assert np.array_equal(loads, rloads) and trees == rtrees
    for lam in (None, 0.0078125):
        assert PC.collective_report(ptopo, rp.routed, lam) == \
            C.collective_report(rtopo, rr.routed, lam)
    assert PC.a2a_trace(ptopo, rp.routed) == C.a2a_trace(rtopo, rr.routed)
    assert np.array_equal(PC.a2a_traffic(rp.routed).matrix,
                          C.a2a_traffic(rr.routed).matrix)
    assert PC.effective_a2a_bandwidth(0.01, 64) == \
        C.effective_a2a_bandwidth(0.01, 64)


def test_workload_fabric_loads_for_the_card():
    """The two stored workload fabrics the card evaluates load into the
    port as 4x4x8 radix-6 fabrics."""
    from pathlib import Path
    root = Path(__file__).parent.parent / "benchmarks" / "results"
    for arch in (MOE_ARCH, DENSE_ARCH):
        topo = convert.load_fabric(root / f"tons_wl_128_{arch}.pkl",
                                   (4, 4, 8))
        assert topo.n == 128
        deg = np.bincount(topo.edges().ravel(), minlength=topo.n)
        assert (deg == 6).all()
