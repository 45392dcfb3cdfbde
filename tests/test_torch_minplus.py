"""The port's int16 hop path and the APSP that stops at its fixpoint,
against the JAX package's (min,+) oracle, Pallas kernel and APSP.

On the CPU ``ops.minplus_hops`` is the plain int16 version
(``ref.minplus_hops_ref``); the CUDA kernel is held to that version on
the card by chip_smoke.py. Held here: the int16 encoding, decoded back,
gives the f32 results bit for bit on hop matrices and their partial
closures; ``ops.apsp`` gives the reference's APSP exactly while it runs
no more squarings than the graph's diameter needs; the wrapper refuses
what the kernel does not take.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as T
from repro.kernels import ops as jops, ref as jref
from repro.kernels.minplus import apsp as pallas_apsp, minplus as pallas_minplus
from repro_torch.kernels import bench_minplus, minplus as kmp, ops, ref

BLOCK = 128   # the Pallas kernel's tile; ragged n is padded to it


def _ring_with_chords(n, chords, seed, isolate=()):
    rng = np.random.default_rng(seed)
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    extra = rng.integers(0, n, (chords, 2))
    e = np.concatenate([ring, extra[extra[:, 0] != extra[:, 1]]])
    keep = ~np.isin(e, list(isolate)).any(axis=1)
    return e[keep]


GRAPHS = {
    "pt_4x4x4": lambda: (T.pt((4, 4, 4)).edges(), 64),
    "pt_4x4x8": lambda: (T.pt((4, 4, 8)).edges(), 128),
    "pdtt_4x4x8": lambda: (T.pdtt((4, 4, 8)).edges(), 128),
    "random_4x4x4": lambda: (T.random_topology((4, 4, 4), seed=3).edges(),
                             64),
    "isolated_node": lambda: (_ring_with_chords(96, 30, 1, isolate=(95,)),
                              96),
    "ragged_100": lambda: (_ring_with_chords(100, 40, 4), 100),
    "ragged_300": lambda: (_ring_with_chords(300, 60, 5), 300),
}


def _f32_hop_matrix(name):
    """The reference's f32 hop matrix of a graph (numpy), with its edges."""
    edges, n = GRAPHS[name]()
    return edges, n, np.array(jops.hop_matrix(edges, n))


def _pad(d):
    """Pad to the Pallas tile as the reference's topology_metrics does:
    1e9 off the diagonal, 0 on it, which leaves the [:n, :n] block of
    every product as it is."""
    n = d.shape[0]
    m = -(-n // BLOCK) * BLOCK
    out = np.full((m, m), 1e9, np.float32)
    np.fill_diagonal(out, 0.0)
    out[:n, :n] = d
    return out, n


def _pallas_product(a, b):
    pa, n = _pad(a)
    pb, _ = _pad(b)
    return np.asarray(pallas_minplus(jnp.asarray(pa), jnp.asarray(pb),
                                     interpret=True))[:n, :n]


def _squarings(d, s):
    for _ in range(s):
        d = np.array(jref.minplus_ref(jnp.asarray(d), jnp.asarray(d)))
    return d


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("s", [0, 2])
def test_minplus_hops_ref_decoded_equals_f32_refs_and_pallas(name, s):
    """A hop matrix after s squarings, times the one after s + 1: the
    int16 product, decoded, equals the port's f32 plain version, the JAX
    oracle and the Pallas kernel (interpret mode) bit for bit."""
    _, n, d0 = _f32_hop_matrix(name)
    a, b = _squarings(d0, s), _squarings(d0, s + 1)
    ha = ops.encode_hops(torch.from_numpy(a))
    hb = ops.encode_hops(torch.from_numpy(b))
    np.testing.assert_array_equal(ops.decode_hops(ha).numpy(), a)
    np.testing.assert_array_equal(ops.decode_hops(hb).numpy(), b)
    got = ops.decode_hops(ref.minplus_hops_ref(ha, hb)).numpy()
    np.testing.assert_array_equal(
        got, ref.minplus_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.minplus_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, _pallas_product(a, b))


@pytest.mark.parametrize("shape", [(64, 96, 80), (100, 70, 130),
                                   (33, 1, 17)])
def test_minplus_hops_ref_equals_numpy_triples_and_chunking(shape,
                                                            monkeypatch):
    """Random int16 values over all of [0, HOP_INF]: min(HOP_INF, min_k
    a + b) computed in int64 by numpy, and the same with 7-deep chunks."""
    M, K, N = shape
    rng = np.random.default_rng(7)
    a = rng.integers(0, ops.HOP_INF + 1, (M, K)).astype(np.int16)
    b = rng.integers(0, ops.HOP_INF + 1, (K, N)).astype(np.int16)
    want = np.minimum(ops.HOP_INF, (a.astype(np.int64)[:, :, None]
                                    + b.astype(np.int64)[None]).min(1))
    got = ref.minplus_hops_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", M * N * 7)
    np.testing.assert_array_equal(
        ref.minplus_hops_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_apsp_stops_at_the_fixpoint_with_the_references_result(name):
    """ops.apsp on the int16 hop matrix equals the port's fixed-count
    oracle, the JAX oracle and the Pallas APSP (interpret mode) bit for
    bit, in at most ceil(log2(n - 1)) and ceil(log2(diameter)) + 1
    squarings."""
    edges, n, d0 = _f32_hop_matrix(name)
    stats = {}
    got = ops.apsp(ops.hop_matrix(edges, n, "cpu"), stats).numpy()
    assert got.dtype == np.float32 and stats["path"] == "hops"
    np.testing.assert_array_equal(
        got, ref.apsp_ref(torch.from_numpy(d0)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.apsp_ref(jnp.asarray(d0))))
    pd, _ = _pad(d0)
    np.testing.assert_array_equal(
        got, np.asarray(pallas_apsp(jnp.asarray(pd), interpret=True))[:n, :n])
    diameter = int(got[got < ops.UNREACHABLE].max())
    assert stats["squarings"] <= math.ceil(math.log2(n - 1))
    assert stats["squarings"] <= math.ceil(math.log2(max(diameter, 1))) + 1


def test_apsp_takes_the_f32_hop_matrix_through_the_hop_path():
    """The reference's f32 hop matrix, encoded, goes through the int16
    path; as it is, through the f32 path (apsp picks the path by dtype).
    Both give the f32 matrix the reference's APSP gives."""
    edges, n, d0 = _f32_hop_matrix("pt_4x4x8")
    want = np.asarray(jref.apsp_ref(jnp.asarray(d0)))
    for d, path in ((ops.encode_hops(torch.from_numpy(d0)), "hops"),
                    (torch.from_numpy(d0), "f32")):
        stats = {}
        got = ops.apsp(d, stats)
        assert stats["path"] == path
        np.testing.assert_array_equal(got.numpy(), want)


def test_apsp_on_a_path_whose_diameter_is_a_power_of_two_needs_the_cap():
    """A 9-node path has diameter 8 = 2^3: three squarings reach it and a
    fourth would only confirm it, so the reference's cap of
    ceil(log2(8)) = 3 ends the loop."""
    n = 9
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    stats = {}
    got = ops.apsp(ops.hop_matrix(edges, n, "cpu"), stats)
    assert stats["squarings"] == 3
    want = np.abs(np.arange(n)[:, None] - np.arange(n)[None]).astype(
        np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_apsp_keeps_the_f32_path_for_matrices_the_hop_path_cannot_hold():
    """Non-integer weights, in f32: the f32 squarings run, stop at the
    fixpoint and give the reference's result."""
    rng = np.random.default_rng(2)
    w = (rng.random((48, 48)) * 3).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    stats = {}
    got = ops.apsp(torch.from_numpy(w), stats)
    assert stats["path"] == "f32"
    assert stats["squarings"] <= math.ceil(math.log2(47))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.apsp_ref(jnp.asarray(w))))


def test_hop_matrix_beyond_the_int16_range_stays_f32(monkeypatch):
    """Above HOP_N_MAX nodes the hop matrix is built in f32 with 1e9 and
    squared on the f32 path (here with HOP_N_MAX lowered to 50)."""
    monkeypatch.setattr(ops, "HOP_N_MAX", 50)
    edges, n, d0 = _f32_hop_matrix("pt_4x4x4")
    h = ops.hop_matrix(edges, n, "cpu")
    assert h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), d0)
    stats = {}
    got = ops.apsp(h, stats)
    assert stats["path"] == "f32"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.apsp_ref(jnp.asarray(d0))))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hop_matrix_encoding_round_trips_to_the_reference_matrix(name):
    edges, n, d0 = _f32_hop_matrix(name)
    h = ops.hop_matrix(edges, n, "cpu")
    assert h.dtype == torch.int16 and h.shape == (n, n)
    assert int(h.max()) == ops.HOP_INF and int(h.min()) == 0
    np.testing.assert_array_equal(ops.decode_hops(h).numpy(), d0)
    assert torch.equal(ops.encode_hops(torch.from_numpy(d0)), h)


def test_hop_wrapper_takes_only_cuda_tensors():
    h = ops.hop_matrix(T.pt((4, 4, 4)).edges(), 64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kmp.minplus_hops(h, h)
    assert kmp.hop_launches == 0


@pytest.mark.parametrize("case", ["float32", "int32", "negative", "above_inf",
                                  "shapes", "strided"])
def test_hop_wrapper_checks_dtype_shape_layout_and_range(case):
    """The hop path's checks run before the device check, so they are
    reached here: int16 only, chained shapes, contiguous operands and
    every value in [0, HOP_INF]."""
    a = torch.zeros((8, 8), dtype=torch.int16)
    b = a.clone()
    match = {"float32": "int16", "int32": "int16", "negative": "outside",
             "above_inf": "outside", "shapes": "chain",
             "strided": "contiguous"}[case]
    if case == "float32":
        a = a.float()
    elif case == "int32":
        b = b.int()
    elif case == "negative":
        b[3, 4] = -1
    elif case == "above_inf":
        a[0, 0] = ops.HOP_INF + 1
    elif case == "shapes":
        b = torch.zeros((7, 8), dtype=torch.int16)
    else:
        a = torch.zeros((8, 16), dtype=torch.int16)[:, ::2]
    with pytest.raises(ValueError, match=match):
        kmp.check_hops(a, b)


def test_hop_wrapper_checks_pass_the_ends_of_the_range():
    a = torch.full((8, 5), ops.HOP_INF, dtype=torch.int16)
    kmp.check_hops(a, torch.zeros((5, 3), dtype=torch.int16))


def test_apsp_refuses_an_int16_matrix_beyond_the_hop_range(monkeypatch):
    monkeypatch.setattr(ops, "HOP_N_MAX", 8)
    with pytest.raises(ValueError, match="at most 8"):
        ops.apsp(torch.zeros((9, 9), dtype=torch.int16))


def test_ops_minplus_hops_dispatch():
    """A CPU tensor takes the plain version; another device raises."""
    h = ops.hop_matrix(T.pt((4, 4, 4)).edges(), 64, "cpu")
    assert torch.equal(ops.minplus_hops(h, h), ref.minplus_hops_ref(h, h))
    m = torch.empty((4, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        ops.minplus_hops(m, m)


def test_bench_minplus_needs_a_card(capsys):
    """The timing script exits 2 without a CUDA device and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would time it")
    assert bench_minplus.main([str(kmp.SOURCE)]) == 2
    assert capsys.readouterr().out == ""
