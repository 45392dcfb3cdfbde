"""The port's simulator modes against the JAX reference: adaptive
escape-VC routing, mid-sweep faults (static and adaptive), bursty,
phased and multi-tenant traffic, the dense oracle kernel and the
watchdog abort. Counter dicts -- ``escaped`` and ``tenants`` included --
must equal (``==``) the reference's on its own tables (the
``_build`` of test_netsim_adaptive.py: robust allowed turns at 4 VCs,
VC 0 reserved for the escape lane), carried over by
``repro_torch.convert``.

The reference simulator calls ``jax.experimental.disable_x64``, which
this JAX release removed; the fixture below patches it back only while
a test runs, never at import time.
"""
import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import fault as F, netsim as NS, routing as R, \
    topology as T
from repro.core.traffic import PhasedTraffic as RefPhased, \
    TenantSpec as RefTenant, TrafficPattern as RefTP, \
    compose_tenants as ref_compose
from repro_torch import convert
from repro_torch.core import netsim as PNS, topology as PT
from repro_torch.core.traffic import (PhasedTraffic, TenantSpec,
                                      TrafficPattern, compose_tenants)

RATES = [0.05, 0.2, 0.5]
SWEEP = dict(cycles=600, warmup=200)
T_FAULT = 250


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The simulator's CPU path is many small ops: intra-op threads only
    add overhead, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_netsim(monkeypatch):
    """The reference simulator, runnable for the length of one test."""
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    return NS


def _port_tables(tab):
    c = tab.csr()
    return convert.sim_tables_from_arrays(dict(
        n=tab.n, n_ch=tab.n_ch, n_vc=tab.n_vc, ch_dst=tab.ch_dst,
        src_indptr=c.src_indptr, dst=c.dst, hop_indptr=c.hop_indptr,
        chan=c.chan, vc=c.vc))


@functools.lru_cache(maxsize=None)
def _pod(spec):
    """The reference's adaptive-suite tables, the first OCS colour's
    fault at T_FAULT, both packages' adaptive specs for it, and the
    port's copy of the tables."""
    topo = T.pt(spec)
    at = R.allowed_turns(topo, n_vc=4, priority="robust")
    sel = R.select_paths(at, K=4, local_search_rounds=1, engine="sharded")
    tab = NS.at_tables(topo, at, sel, reserve_escape=True)
    ev = F.fault_event(at, F.colors_in_use(topo)[0], T_FAULT)
    return dict(topo=topo, ptopo=PT.pt(spec), at=at, tab=tab,
                ptab=_port_tables(tab), ev=ev,
                ref_spec=NS.adaptive_spec(topo, dead_channels=ev[1]),
                spec=PNS.adaptive_spec(PT.pt(spec), dead_channels=ev[1]))


@pytest.fixture(scope="module", params=[(4, 4, 4), (4, 4, 8)])
def pod(request):
    return _pod(request.param)


def _tenants(n, spec_cls, compose):
    """Two overlapping tenants (test_workload.py's), built by one package."""
    rng = np.random.default_rng(0)
    a = np.arange(0, n // 2)
    b = np.arange(n // 2 - 8, n - 8)
    return compose(n, [spec_cls("jobA", a, rng.random((len(a),) * 2), 1.0),
                       spec_cls("jobB", b, rng.random((len(b),) * 2), 0.5)])


def _mode(name, p):
    """(reference kwargs, port kwargs) of one mode on pod ``p``."""
    n = p["topo"].n
    ev = p["ev"]
    ref, port = {}, {}
    if name.startswith("adaptive"):
        ref["adaptive"], port["adaptive"] = p["ref_spec"], p["spec"]
    if name.endswith("fault"):
        ref["fault"] = port["fault"] = ev
    if name == "adaptive_patience1":
        ref["patience"] = port["patience"] = 1
    if name.startswith("bursty"):
        phase = np.arange(n) % 64 if name == "bursty_staggered" else None
        ref["traffic"] = RefTP.uniform(n).with_burst(64, duty=0.25,
                                                     gain=3.0, phase=phase)
        port["traffic"] = TrafficPattern.uniform(n).with_burst(
            64, duty=0.25, gain=3.0, phase=phase)
    if name == "phased_one":
        ref["traffic"] = RefPhased("one", (RefTP.hotspot(n, frac=0.4),),
                                   (100,))
        port["traffic"] = PhasedTraffic(
            "one", (TrafficPattern.hotspot(n, frac=0.4),), (100,))
    if name == "phased_multi":
        ref["traffic"] = RefPhased(
            "multi", (RefTP.uniform(n), RefTP.hotspot(n, frac=0.4),
                      RefTP.uniform(n).with_burst(32)), (90, 50, 40))
        port["traffic"] = PhasedTraffic(
            "multi", (TrafficPattern.uniform(n),
                      TrafficPattern.hotspot(n, frac=0.4),
                      TrafficPattern.uniform(n).with_burst(32)),
            (90, 50, 40))
    if name.startswith("tenants"):
        ref["traffic"] = _tenants(n, RefTenant, ref_compose)
        port["traffic"] = _tenants(n, TenantSpec, compose_tenants)
    return ref, port


def _assert_conserving(trace):
    for r in trace:
        assert r["injected_total"] == r["consumed_total"] + r["in_flight"]
        assert r["delivered_tagged"] <= r["accepted"] <= r["offered"]
        for t in r.get("tenants", {}).values():
            assert t["injected"] == t["consumed"] + t["in_flight"]


BOTH_PODS = ["adaptive", "static_fault", "adaptive_fault", "bursty",
             "phased_multi", "tenants"]


@pytest.mark.parametrize("mode", BOTH_PODS)
def test_mode_equals_reference(pod, mode, ref_netsim):
    ref_kw, kw = _mode(mode, pod)
    want = ref_netsim.sweep(pod["tab"], RATES, **SWEEP, **ref_kw)
    stats: dict = {}
    got = PNS.sweep(pod["ptab"], RATES, stats=stats, device="cpu",
                    **SWEEP, **kw)
    assert got == want
    assert stats["cycles_run"] == SWEEP["cycles"]
    _assert_conserving(got)
    if mode == "tenants":
        assert all(set(r["tenants"]) == {"jobA", "jobB"} for r in got)


@pytest.mark.parametrize("mode", ["adaptive_patience1", "bursty_staggered",
                                  "phased_one"])
def test_mode_equals_reference_4x4x4(mode, ref_netsim):
    p = _pod((4, 4, 4))
    ref_kw, kw = _mode(mode, p)
    want = ref_netsim.sweep(p["tab"], RATES, **SWEEP, **ref_kw)
    got = PNS.sweep(p["ptab"], RATES, device="cpu", **SWEEP, **kw)
    assert got == want
    _assert_conserving(got)
    if mode == "adaptive_patience1":
        # an impatient threshold makes the escape lane carry traffic
        assert all(r["escaped"] > 0 for r in got)
    if mode == "phased_one":
        # one phase is the stationary pattern, draw for draw
        steady = PNS.sweep(p["ptab"], RATES, device="cpu",
                           traffic=TrafficPattern.hotspot(p["topo"].n,
                                                          frac=0.4), **SWEEP)
        assert got == steady


def test_adaptive_spec_equals_reference(pod):
    topo, ptopo, ev = pod["topo"], pod["ptopo"], pod["ev"]
    for dead in (None, ev[1]):
        want = NS.adaptive_spec(topo, dead_channels=dead)
        got = PNS.adaptive_spec(ptopo, dead_channels=dead)
        assert got.D == want.D
        for f in ("esc", "outch", "minmask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("mode", ["static", "adaptive_fault", "tenants"])
def test_dense_kernel_equals_csr_and_reference(mode, ref_netsim):
    p = _pod((4, 4, 4))
    ref_kw, kw = _mode(mode, p)
    want = ref_netsim.sweep(p["tab"], RATES, kernel="dense", **SWEEP,
                            **ref_kw)
    stats: dict = {}
    got = PNS.sweep(p["ptab"], RATES, kernel="dense", stats=stats,
                    device="cpu", **SWEEP, **kw)
    assert got == want
    assert stats["kernel"] == "dense"
    assert got == PNS.sweep(p["ptab"], RATES, device="cpu", **SWEEP, **kw)


@pytest.mark.parametrize("adaptive", [False, True])
def test_watchdog_abort_equals_reference(adaptive, ref_netsim):
    """Every channel dies at cycle 500 (the adaptive spec's post-fault
    plane knows it, so no escape route is left): the in-flight packets
    can never move again, the watchdog fires and the run stops early --
    at the reference's cycle, with its counters."""
    p = _pod((4, 4, 4))
    dead = np.arange(p["tab"].n_ch, dtype=np.int64)
    kw = dict(cycles=4000, warmup=500, fault=(500, dead), watchdog=128)
    s_ref: dict = {}
    s_port: dict = {}
    want = ref_netsim.sweep(
        p["tab"], [0.2], stats=s_ref, **kw,
        adaptive=NS.adaptive_spec(p["topo"], dead) if adaptive else None)
    got = PNS.sweep(
        p["ptab"], [0.2], stats=s_port, device="cpu", **kw,
        adaptive=PNS.adaptive_spec(p["ptopo"], dead) if adaptive else None)
    assert got == want
    assert s_port["cycles_run"] == s_ref["cycles_run"] < 4000
    assert got[0]["stalled_at"] >= 500 and got[0]["in_flight"] > 0


def _bad_call(case, ns, tab, spec, tab8):
    """The calls test_netsim_adaptive.py expects to raise, in one
    package's terms."""
    kw = {
        "negative_fault_cycle": dict(fault=(-5, [0])),
        "fault_after_the_run": dict(cycles=1000, fault=(2000, [0])),
        "unknown_channel": dict(fault=(100, [tab.n_ch + 3])),
        "patience_0": dict(adaptive=spec, patience=0),
        "watchdog_0": dict(watchdog=0),
        "spec_of_another_topology": dict(adaptive=spec),
    }[case]
    return lambda **dev: ns.sweep(
        tab8 if case == "spec_of_another_topology" else tab, [0.1], **kw,
        **dev)


@pytest.mark.parametrize("case", ["negative_fault_cycle",
                                  "fault_after_the_run", "unknown_channel",
                                  "patience_0", "watchdog_0",
                                  "spec_of_another_topology",
                                  "one_vc_adaptive", "negative_fault_event"])
def test_validation_errors_match_reference(case, ref_netsim):
    p, p8 = _pod((4, 4, 4)), _pod((4, 4, 8))
    if case == "negative_fault_event":
        from repro_torch.core import fault as PF
        with pytest.raises(ValueError) as want:
            F.fault_event(p["at"], 0, -1)
        with pytest.raises(want.type):
            PF.fault_event(p["at"], 0, -1)
        return
    if case == "one_vc_adaptive":
        ref = lambda **d: ref_netsim.sweep(                # noqa: E731
            NS.dor_tables(p["topo"], n_vc=1), [0.1],
            adaptive=NS.adaptive_spec(p["topo"]), **d)
        port = lambda **d: PNS.sweep(                      # noqa: E731
            PNS.dor_tables(p["ptopo"], n_vc=1), [0.1],
            adaptive=PNS.adaptive_spec(p["ptopo"]), **d)
    else:
        ref = _bad_call(case, ref_netsim, p["tab"],
                        NS.adaptive_spec(p["topo"]), p8["tab"])
        port = _bad_call(case, PNS, p["ptab"], p["spec"], p8["ptab"])
    with pytest.raises(Exception) as want:
        ref()
    with pytest.raises(want.type) as got:
        port(device="cpu")
    assert want.type is ValueError
    assert str(got.value) == str(want.value)
