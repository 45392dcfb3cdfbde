"""The port's simulator against the JAX reference: counter dicts equal
(``==``) on the reference's own tables (carried over by
``repro_torch.convert``) for the static cases of test_netsim_csr.py and
the saturation search.

The reference simulator calls ``jax.experimental.disable_x64``, which
this JAX release removed; the fixtures below patch it back only while
they run the reference, never at import time.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import fault as F, netsim as NS, routing as R, \
    topology as T
from repro.core.traffic import TrafficPattern as RefTP
from repro_torch import convert
from repro_torch.core import netsim as PNS, topology as PT
from repro_torch.core.traffic import (PhasedTraffic, TenantSpec,
                                      TrafficPattern, compose_tenants)

SRC = Path(__file__).parent.parent / "src"
RATES = [0.02, 0.08, 0.2, 0.6]
SWEEP = dict(cycles=600, warmup=200)
SAT = dict(step=0.05, cycles=1500, warmup=500)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The simulator's CPU path is many small ops: intra-op threads only
    add overhead, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shim(mp):
    mp.setattr(jax.experimental, "disable_x64",
               lambda: jax.enable_x64(False), raising=False)


@pytest.fixture
def ref_netsim(monkeypatch):
    """The reference simulator, runnable for the length of one test."""
    _shim(monkeypatch)
    return NS


def _port_tables(tab):
    c = tab.csr()
    return convert.sim_tables_from_arrays(dict(
        n=tab.n, n_ch=tab.n_ch, n_vc=tab.n_vc, ch_dst=tab.ch_dst,
        src_indptr=c.src_indptr, dst=c.dst, hop_indptr=c.hop_indptr,
        chan=c.chan, vc=c.vc))


@functools.lru_cache(maxsize=None)
def _ref_pod(spec):
    """Reference AT tables (as in test_netsim_csr.py), the fault region
    its fault_correlated pattern targets, and the port's copy."""
    topo = T.pt(spec)
    at = R.allowed_turns(topo, n_vc=2, priority="apl")
    sel = R.select_paths(at, K=4, local_search_rounds=1, engine="sharded")
    tab = NS.at_tables(topo, at, sel)
    region = F.fault_region_nodes(at, F.colors_in_use(topo)[0])
    return topo, tab, np.asarray(region), _port_tables(tab)


@pytest.fixture(scope="module", params=[(4, 4, 4), (4, 4, 8)])
def pod(request):
    return _ref_pod(request.param)


def _pattern(name, n, region):
    """The same pattern built by the reference and by the port."""
    if name == "uniform":
        return None, None
    if name == "hotspot":
        return (RefTP.hotspot(n, frac=0.4),
                TrafficPattern.hotspot(n, frac=0.4))
    return (RefTP.fault_correlated(n, region, frac=0.6, src_boost=2.0),
            TrafficPattern.fault_correlated(n, region, frac=0.6,
                                            src_boost=2.0))


@pytest.mark.parametrize("pattern", ["uniform", "hotspot",
                                     "fault_correlated"])
def test_sweep_equals_reference_on_at_tables(pod, pattern, ref_netsim):
    topo, tab, region, ptab = pod
    ref_tp, tp = _pattern(pattern, topo.n, region)
    want = ref_netsim.sweep(tab, RATES, traffic=ref_tp, **SWEEP)
    stats: dict = {}
    got = PNS.sweep(ptab, RATES, traffic=tp, stats=stats, device="cpu",
                    **SWEEP)
    assert got == want
    assert stats["kernel"] == "csr"
    assert stats["cycles_run"] == SWEEP["cycles"]
    for r in got:
        assert r["injected_total"] == r["consumed_total"] + r["in_flight"]


def test_sweep_equals_reference_on_dor_tables_and_seeds(pod, ref_netsim):
    topo = pod[0]
    tab = NS.dor_tables(topo)
    ptab = PNS.dor_tables(PT.pt(topo.pod.dims))
    got = {}
    for seed in (0, 3):
        want = ref_netsim.run(tab, 0.15, cycles=900, warmup=300, seed=seed)
        got[seed] = PNS.run(ptab, 0.15, cycles=900, warmup=300, seed=seed,
                            device="cpu")
        assert got[seed] == want
    assert got[0] != got[3]


def test_watchdog_early_stop_equals_reference(ref_netsim):
    """Long packets, a short watchdog and almost no load: every lane
    stalls and the run stops early -- at the reference's cycle."""
    tab = NS.dor_tables(T.pt((4, 4, 4)))
    ptab = PNS.dor_tables(PT.pt((4, 4, 4)))
    kw = dict(cycles=900, warmup=300, flits=64, watchdog=8)
    s_ref: dict = {}
    s_port: dict = {}
    want = ref_netsim.sweep(tab, [0.001, 0.002], stats=s_ref, **kw)
    got = PNS.sweep(ptab, [0.001, 0.002], stats=s_port, device="cpu", **kw)
    assert got == want
    assert s_port["cycles_run"] == s_ref["cycles_run"] < 900
    assert all(r["stalled_at"] >= 0 for r in got)


def test_saturation_point_equals_reference(ref_netsim):
    _, tab, _, ptab = _ref_pod((4, 4, 8))
    sat, trace = ref_netsim.saturation_point(tab, **SAT)
    got_sat, got_trace = PNS.saturation_point(ptab, device="cpu", **SAT)
    assert got_sat == sat > 0
    assert got_trace == trace


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.core.pipeline, repro_torch.core.netsim\n"
            "import repro_torch.kernels.ops, repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sweep_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ptab = PNS.dor_tables(PT.pt((4, 4, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        PNS.sweep(ptab, [0.1], cycles=10, warmup=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        PNS.saturation_point(ptab, cycles=10, warmup=5)


@pytest.mark.parametrize("flag", ["adaptive", "fault", "dense", "bursty",
                                  "phased", "tenants"])
def test_not_yet_ported_options_raise(flag):
    ptab = PNS.dor_tables(PT.pt((4, 4, 4)))
    n = ptab.n
    kw = dict(cycles=10, warmup=5, device="cpu")
    uni = TrafficPattern.uniform(n)
    kw.update({
        "adaptive": dict(adaptive=object()),
        "fault": dict(fault=(5, [0])),
        "dense": dict(kernel="dense"),
        "bursty": dict(traffic=uni.with_burst(8)),
        "phased": dict(traffic=PhasedTraffic("p", (uni, uni), (4, 4))),
        "tenants": dict(traffic=compose_tenants(n, [TenantSpec(
            "job", np.arange(n), np.ones((n, n)) - np.eye(n))])),
    }[flag])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PNS.sweep(ptab, [0.1], **kw)
