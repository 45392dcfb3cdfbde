"""The port's online repair (``repro_torch.core.repair``) against the JAX
package's on PDTT 4^3: the cold ``ServingState.build`` (its APL hop
matrix from the (min,+) plain version, device="cpu"), single and chained
OCS repairs, restoration, degraded mode and its recompute fallback, and
the full-recompute oracle must leave identical CSR tables, loads, VC
counts and ``RepairResult`` fields (every field but the wall-clock
ones)."""
import functools

import numpy as np
import pytest
import torch

from repro.core import fault as F, repair as RR, topology as T
from repro_torch.core import fault as PF, repair as PR, topology as PT

CSR_FIELDS = ("src_indptr", "dst", "hop_indptr", "chan", "vc")
STATE_ARRAYS = ("loads", "vc_counts", "dead", "dist", "best", "lost",
                "touched")
RESULT_FIELDS = ("flows_rerouted", "l_max", "unreachable", "deadlock_free",
                 "fallback", "readmitted", "lost", "restored")


@functools.lru_cache(maxsize=None)
def _states(n_vc, K):
    """The reference's and the port's cold builds of one configuration."""
    ref = RR.ServingState.build(T.pdtt((4, 4, 4)), n_vc=n_vc, K=K, seed=0,
                                robust=True)
    port = PR.ServingState.build(PT.pdtt((4, 4, 4)), n_vc=n_vc, K=K,
                                 seed=0, robust=True, device="cpu")
    return ref, port


@pytest.fixture(scope="module", params=[(4, 8), (2, 4)],
                ids=["vc4_k8", "vc2_k4"])
def served(request):
    return _states(*request.param)


def _assert_table_equal(a, b):
    assert (a.n, a.n_ch, a.n_vc) == (b.n, b.n_ch, b.n_vc)
    for f in CSR_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype, f
        np.testing.assert_array_equal(va, vb, err_msg=f)


def _assert_state_equal(got, want):
    _assert_table_equal(got.table, want.table)
    for f in STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert set(got.at.allowed) == set(want.at.allowed)
    assert (got.K, got.seed, got.l_max, got.served_fraction) \
        == (want.K, want.seed, want.l_max, want.served_fraction)


def _counts(stats):
    """A stats dict without its stage timings (``*_s``), which differ
    by nature; every count must not."""
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


def _assert_result_equal(got, want):
    for f in RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.pool_flows, want.pool_flows)
    assert _counts(got.stats) == _counts(want.stats)
    _assert_state_equal(got.state, want.state)


def _node_channels(at, node):
    ch = at.channels
    return np.nonzero((ch.src == node) | (ch.dst == node))[0] \
        .astype(np.int64)


def test_build_equals_reference(served):
    ref, port = served
    _assert_state_equal(port, ref)
    assert _counts(port.stats) == _counts(ref.stats)


def test_build_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PR.ServingState.build(PT.pdtt((4, 4, 4)), n_vc=2, K=4)


@pytest.mark.parametrize("k", [0, 1])
def test_repair_fault_equals_reference(served, k):
    ref, port = served
    color = F.colors_in_use(ref.topo)[k]
    want = RR.repair_fault(ref, F.dead_channels_for_color(ref.at, color),
                           verify="full")
    got = PR.repair_fault(port, PF.dead_channels_for_color(port.at, color),
                          verify="full")
    _assert_result_equal(got, want)
    assert got.unreachable == 0 and got.deadlock_free and not got.fallback


def test_repair_chain_and_restore_equal_reference(served):
    """Two OCS losses one after the other, a partial heal of the first,
    then the full heal."""
    ref, port = served
    c0, c1 = F.colors_in_use(ref.topo)[:2]
    d0 = F.dead_channels_for_color(ref.at, c0)
    d1 = F.dead_channels_for_color(ref.at, c1)
    r_cur, p_cur = ref, port
    for step in (lambda m, s: m.repair_fault(s, d0),
                 lambda m, s: m.repair_fault(s, d1),
                 lambda m, s: m.restore_channels(s, d0, verify="full"),
                 lambda m, s: m.restore_channels(s, d1, verify="full")):
        want, got = step(RR, r_cur), step(PR, p_cur)
        _assert_result_equal(got, want)
        r_cur, p_cur = want.state, got.state
    assert len(p_cur.dead) == 0 and len(p_cur.lost) == 0


def test_degraded_mode_equals_reference(served):
    """Node 0 cut off: degraded serving (lost flows keep their slots),
    its heal, and the legacy recompute fallback."""
    ref, port = served
    dead = _node_channels(ref.at, 0)
    want = RR.repair_fault(ref, dead, verify="full")
    got = PR.repair_fault(port, dead, verify="full")
    _assert_result_equal(got, want)
    assert got.lost == 2 * (ref.topo.n - 1) and not got.fallback
    heal_want = RR.restore_channels(want.state, dead, verify="full")
    heal_got = PR.restore_channels(got.state, dead, verify="full")
    _assert_result_equal(heal_got, heal_want)
    fb_want = RR.repair_fault(ref, dead, on_disconnect="recompute")
    fb_got = PR.repair_fault(port, dead, on_disconnect="recompute")
    _assert_result_equal(fb_got, fb_want)
    assert fb_got.fallback


def test_full_recompute_equals_reference(served):
    ref, port = served
    dead = F.dead_channels_for_color(ref.at, F.colors_in_use(ref.topo)[0])
    r_routed, r_counts, r_at = RR.full_recompute(ref, dead)
    p_routed, p_counts, p_at = PR.full_recompute(port, dead)
    _assert_table_equal(p_routed.table, r_routed.table)
    np.testing.assert_array_equal(p_counts, r_counts)
    assert set(p_at.allowed) == set(r_at.allowed)
    assert (p_routed.l_max, p_routed.unreachable) \
        == (r_routed.l_max, r_routed.unreachable)


def test_repair_input_errors_match_reference(served):
    ref, port = served
    bad = [ref.at.channels.n + 3]
    for fn in ("repair_fault", "restore_channels"):
        with pytest.raises(ValueError) as want:
            getattr(RR, fn)(ref, bad)
        with pytest.raises(ValueError) as got:
            getattr(PR, fn)(port, bad)
        assert str(got.value) == str(want.value)
