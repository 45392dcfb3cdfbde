"""The port's TONS synthesis against the JAX reference (mirrors
test_synthesis.py): the batched LP assembly gives the reference's COO
entry for entry (order and duplicates included), the greedy fixing loop
gives the reference's fabric under HiGHS and under PDHG (LP values
within 1e-9: PDHG sums in XLA's order there and in CSR order here), and
the end-to-end evaluation routes it to the reference's numbers.

Importing ``repro.core.lp`` switches JAX to x64 for the whole process
(ROADMAP caveat R3); both packages get explicit numpy arrays here.
"""
import numpy as np
import pytest
import torch

from repro.core import synthesis as SY, topology as T
from repro_torch.core import mcf as PM, smallgraphs as PG, \
    synthesis as PS, topology as PT

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pw(a, b):
    return (np.asarray(a) + np.asarray(b)) % 3 * 0.5


@pytest.mark.parametrize("spec,kw", [
    ((4, 4, 4), {}),
    ((4, 4, 4), {"symmetric": False}),
    ((4, 4, 4), {"pair_weight": _pw}),
    ((4, 4, 8), {}),
    ((4, 4, 8), {"fault_f": 1}),
    ((4, 4, 8), {"symmetric": False}),
])
def test_synthesis_lp_identical_to_reference(spec, kw):
    got = PS.build_synthesis_lp(PT.Pod(spec), **kw)
    want = SY.build_synthesis_lp(T.Pod(spec), **kw)
    assert got.n_var == want.n_var and got.A.shape == want.A.shape
    for f in ("rows", "cols", "vals"):      # same order, duplicates kept
        g, w = getattr(got.A, f), getattr(want.A, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in ("c", "b", "lo", "hi"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.m_slice == want.m_slice
    assert got.orbit_keys == want.orbit_keys
    assert got.orbit_members == want.orbit_members
    assert got.port_of == want.port_of
    assert np.array_equal(got.pc.perms, want.pc.perms)


def test_synthesis_lp_rejects_unported_and_unknown_engines():
    with pytest.raises(ValueError, match="reference"):
        PS.build_synthesis_lp(PT.Pod((4, 4, 4)), engine="reference")
    with pytest.raises(ValueError):
        PS.build_synthesis_lp(PT.Pod((4, 4, 4)), engine="nope")


def _same_synthesis(got, want):
    assert got.topology.optical == want.topology.optical
    assert (got.status, got.n_orbits, got.n_fixed, got.n_completed) == \
        (want.status, want.n_orbits, want.n_fixed, want.n_completed)
    np.testing.assert_allclose(got.lambdas, want.lambdas, rtol=0, atol=TOL)
    gs, ws = got.stats, want.stats
    for k in ("n_var", "n_rows", "nnz", "interval"):
        assert gs[k] == ws[k], k
    assert [(s["solver"], s["status"], s["iters"]) for s in gs["solves"]] \
        == [(s["solver"], s["status"], s["iters"]) for s in ws["solves"]]


@pytest.fixture(scope="module")
def small_synth():
    return PS.synthesize((4, 4, 4), interval=48)


def test_synthesize_highs_equals_reference_and_recovers_torus(small_synth):
    """HiGHS rounds: the reference's fabric, which on one cube is the
    4-torus wrap (one perfect matching per OCS group)."""
    _same_synthesis(small_synth, SY.synthesize((4, 4, 4), interval=48))
    want = {(u, v) for u, v, _ in PT.pt_optical(PT.Pod((4, 4, 4)))}
    assert {(u, v) for u, v, _ in small_synth.topology.optical} == want
    assert small_synth.n_fixed == small_synth.n_orbits == 48
    lam = PM.mcf_topology(small_synth.topology, prefer="highs")
    assert abs(small_synth.lp_lambda - lam) < 1e-4


def test_synthesize_pdhg_equals_reference():
    """PDHG rounds (the reference's defaults but 2000 iterations): the
    same fixed orbits in the same order, so the same fabric."""
    got = PS.synthesize((4, 4, 4), interval=48, prefer="pdhg",
                        max_lp_iters=2000, device="cpu")
    want = SY.synthesize((4, 4, 4), interval=48, prefer="pdhg",
                         max_lp_iters=2000)
    _same_synthesis(got, want)
    assert got.stats["solves"][0]["solver"] == "pdhg"


def test_synthesize_pdhg_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.synthesize((4, 4, 4), interval=48, prefer="pdhg",
                      max_lp_iters=250)


def test_evaluate_end_to_end_equals_reference(small_synth):
    """to_topology() -> route_pod (APL on the APSP's plain version) ->
    VC allocation -> deadlock-free verification: every scalar but the
    wall times equals the reference's."""
    topo = small_synth.to_topology()
    assert topo is small_synth.topology
    got = PS.evaluate_end_to_end(topo, K=4, device="cpu")
    ref_topo = T.Topology(T.Pod((4, 4, 4)), topo.optical, name=topo.name)
    want = SY.evaluate_end_to_end(ref_topo, K=4)
    timed = {k for k in want if k.endswith("_s")}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert got["deadlock_free"] and got["unreachable"] == 0
    assert got["l_max"] >= got["load_lower_bound"] > 0


def test_synthesize_directed_complete_graph():
    """With r = n-1 the only degree-saturating topology is the complete
    digraph."""
    n, r = 6, 5
    edges, _ = PG.synthesize_directed(n, r, interval=5)
    assert len(edges) == n * (n - 1)
    complete = np.array([(a, b) for a in range(n)
                         for b in range(n) if a != b], np.int32)
    assert abs(PG.directed_mcf(edges, n) -
               PG.directed_mcf(complete, n)) < 1e-8
