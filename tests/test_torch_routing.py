"""The port's route_pod against the JAX package's, on the host path with
the all-pairs hop matrix from the (min,+) plain version (device="cpu"):
allowed-turn sets, routed and VC-allocated CSR tables, and l_max must be
identical."""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import netsim as NS, routing as R, topology as T
from repro.core.pipeline import route_pod as ref_route_pod
from repro_torch import convert
from repro_torch.core import netsim as PNS, routing as PR, topology as PT
from repro_torch.core.pipeline import PipelineConfig, route_pod

TONS_128 = Path(__file__).parent.parent / "benchmarks" / "results" \
    / "tons_128.pkl"
CSR_FIELDS = ("src_indptr", "dst", "hop_indptr", "chan", "vc")


def _fabrics(name):
    if name == "tons_128":
        optical = pickle.load(open(TONS_128, "rb"))["optical"]
        return (T.Topology(T.Pod((4, 4, 8)), [tuple(e) for e in optical]),
                convert.load_fabric(TONS_128, (4, 4, 8)))
    spec = {"pt_4x4x4": (4, 4, 4), "pt_4x4x8": (4, 4, 8)}[name]
    return T.pt(spec), PT.pt(spec)


def _assert_csr_equal(a, b):
    assert (a.n, a.n_ch, a.n_vc) == (b.n, b.n_ch, b.n_vc)
    for f in CSR_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype, f
        np.testing.assert_array_equal(va, vb, err_msg=f)


@pytest.mark.parametrize("fabric", ["pt_4x4x4", "pt_4x4x8", "tons_128"])
def test_route_pod_identical_to_reference(fabric):
    ref_topo, topo = _fabrics(fabric)
    want = ref_route_pod(ref_topo)
    got = route_pod(topo, PipelineConfig(), device="cpu")
    assert got.at.allowed == want.at.allowed
    _assert_csr_equal(got.routed.table, want.routed.table)
    _assert_csr_equal(got.tables.table, want.tables.table)
    np.testing.assert_array_equal(got.tables.ch_dst, want.tables.ch_dst)
    assert got.l_max == want.l_max
    assert got.avg_hops == want.avg_hops
    assert got.unreachable == want.unreachable == 0


@pytest.mark.parametrize("spec", [(4, 4, 4), (4, 4, 8)])
def test_dor_tables_identical_to_reference(spec):
    want = NS.dor_tables(T.pt(spec))
    got = PNS.dor_tables(PT.pt(spec))
    for f in ("path", "vcs", "hops"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    _assert_csr_equal(got.csr(), want.csr())


def test_load_lower_bound_matches_reference():
    assert PR.load_lower_bound(PT.pt((4, 4, 8)), device="cpu") \
        == R.load_lower_bound(T.pt((4, 4, 8)))


def test_route_pod_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        route_pod(PT.pt((4, 4, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        PR.allowed_turns(PT.pt((4, 4, 4)))


def _lose_flows(t, lost):
    """``t`` with the flows in ``lost`` cut to zero length, as degraded
    serving leaves disconnected pairs."""
    lens = np.diff(t.hop_indptr)
    keep = np.repeat(~np.isin(np.arange(len(lens)), lost), lens)
    lens = np.where(np.isin(np.arange(len(lens)), lost), 0, lens)
    hop_indptr = np.zeros_like(t.hop_indptr)
    np.cumsum(lens, out=hop_indptr[1:])
    return type(t)(t.n, t.n_ch, t.n_vc, t.src_indptr.copy(), t.dst.copy(),
                   hop_indptr, t.chan[keep], t.vc[keep])


@pytest.mark.parametrize("where", ["leading", "trailing", "both"])
def test_verify_deadlock_free_on_lost_boundary_flows(where):
    from repro.core.pathtable import CSRPathTable as RefCSR
    from repro.core.vcalloc import verify_deadlock_free as ref_verify
    from repro_torch.core.vcalloc import verify_deadlock_free

    ref_topo, topo = _fabrics("pt_4x4x4")
    want = ref_route_pod(ref_topo)
    got = route_pod(topo, PipelineConfig(), device="cpu")
    t = got.tables.table
    lens = np.diff(t.hop_indptr)
    last = int(np.nonzero(lens >= 2)[0][-1])
    lost = {"leading": [0], "trailing": list(range(last + 1, len(lens))),
            "both": [0] + list(range(last + 1, len(lens)))}[where]
    assert lost
    deg = _lose_flows(t, lost)
    comp = deg.compact()[0]
    assert verify_deadlock_free(got.at, deg)
    assert verify_deadlock_free(got.at, comp)
    assert ref_verify(want.at, RefCSR(*(getattr(comp, f) for f in (
        "n", "n_ch", "n_vc") + CSR_FIELDS)))
    # an illegal turn on the last pair of the table is still caught
    deg = _lose_flows(t, sorted(set(lost) | set(range(last + 1, len(lens)))))
    sg = got.at.state_graph()
    prev = np.int64(deg.chan[-2]) * deg.n_vc + deg.vc[-2]
    cand = np.arange(deg.n_ch * deg.n_vc, dtype=np.int64)
    bad = int(cand[~sg.has_edges(np.full_like(cand, prev), cand)][0])
    deg.chan[-1], deg.vc[-1] = bad // deg.n_vc, bad % deg.n_vc
    assert not verify_deadlock_free(got.at, deg)
