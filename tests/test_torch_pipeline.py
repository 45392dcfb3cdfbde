"""The whole route-and-simulate slice: the port's own route_pod and
saturation_point, with no reference code in the loop, against the JAX
chain route_pod -> saturation_point on the same fabric."""
import jax
import jax.experimental
import pytest
import torch

from repro.core import netsim as NS, topology as T
from repro.core.pipeline import route_pod as ref_route_pod
from repro_torch.core import netsim as PNS, topology as PT
from repro_torch.core.pipeline import PipelineConfig, route_pod

SAT = dict(step=0.05, cycles=1500, warmup=500)


def test_route_and_simulate_slice_equals_reference(monkeypatch):
    # the reference simulator calls jax.experimental.disable_x64, which
    # this JAX release removed: patch it back for this test only
    monkeypatch.setattr(jax.experimental, "disable_x64",
                        lambda: jax.enable_x64(False), raising=False)
    want_rp = ref_route_pod(T.pt((4, 4, 8)))
    sat, trace = NS.saturation_point(want_rp.tables, **SAT)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # many small ops: threads only add cost
    try:
        rp = route_pod(PT.pt((4, 4, 8)), PipelineConfig(), device="cpu")
        got_sat, got_trace = PNS.saturation_point(rp.tables, device="cpu",
                                                  **SAT)
    finally:
        torch.set_num_threads(threads)
    assert rp.l_max == want_rp.l_max
    assert got_sat == sat > 0
    assert got_trace == trace
    for r in got_trace:
        assert r["injected_total"] == r["consumed_total"] + r["in_flight"]
