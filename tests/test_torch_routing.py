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
