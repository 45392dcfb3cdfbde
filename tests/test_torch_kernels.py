"""The port's (min,+) path against the JAX package's.

On the CPU the port's wrappers take the plain torch version (the CUDA
kernel is held to the same plain version on the card by chip_smoke.py).
Held here: the plain version equals the JAX oracle and the Pallas kernel
(interpret mode) exactly, and the APSP path gives the reference's
diameter, average hops and scipy's distance matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as T
from repro.kernels import ops as jops, ref as jref
from repro.kernels.minplus import minplus as pallas_minplus
from repro_torch.core import topology as PT
from repro_torch.kernels import minplus as kmp, ops, ref


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((M, K), np.float32) * 10).astype(np.float32)
    b = (rng.random((K, N), np.float32) * 10).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384),
                                   (128, 256, 128)])
def test_minplus_ref_equals_jax_ref_and_pallas_kernel(shape):
    M, K, N = shape
    a, b = _inputs(M, K, N)
    got = ref.minplus_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want_ref = np.asarray(jref.minplus_ref(jnp.asarray(a), jnp.asarray(b)))
    want_pallas = np.asarray(pallas_minplus(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


def test_minplus_ref_chunking_does_not_change_the_result(monkeypatch):
    a, b = _inputs(64, 96, 80, seed=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = ref.minplus_ref(ta, tb)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 64 * 80 * 7)   # 7-deep chunks
    np.testing.assert_array_equal(ref.minplus_ref(ta, tb).numpy(),
                                  whole.numpy())


def test_ops_minplus_on_cpu_is_the_plain_version():
    a, b = _inputs(96, 64, 32, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(ops.minplus(ta, tb).numpy(),
                                  ref.minplus_ref(ta, tb).numpy())


def test_apsp_ref_equals_jax_apsp_on_a_random_graph():
    rng = np.random.default_rng(0)
    n = 128
    d0 = np.full((n, n), 1e9, np.float32)
    np.fill_diagonal(d0, 0)
    for _ in range(3 * n):
        u, v = rng.integers(0, n, 2)
        if u != v:
            d0[u, v] = d0[v, u] = 1.0
    got = ref.apsp_ref(torch.from_numpy(d0)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.apsp_ref(
        jnp.asarray(d0))))
    np.testing.assert_array_equal(ops.apsp(torch.from_numpy(d0)).numpy(),
                                  got)


def test_topology_metrics_match_reference_pallas_path():
    topo = PT.pt((4, 4, 8))
    diam, avg = ops.topology_metrics(topo.edges(), topo.n, device="cpu")
    ref_diam, ref_avg = jops.topology_metrics(T.pt((4, 4, 8)).edges(),
                                              topo.n)
    assert diam == ref_diam
    assert abs(avg - ref_avg) < 1e-6


def test_topology_metrics_unpadded_match_padded_reference_at_ragged_n():
    """n = 100 is no multiple of the 128 tile: the reference pads, the
    port does not, and both give the same diameter and average hops."""
    rng = np.random.default_rng(4)
    n = 100
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    chords = rng.integers(0, n, (40, 2))
    edges = np.concatenate([ring, chords[chords[:, 0] != chords[:, 1]]])
    diam, avg = ops.topology_metrics(edges, n, device="cpu")
    ref_diam, ref_avg = jops.topology_metrics(edges, n)
    assert diam == ref_diam
    assert abs(avg - ref_avg) < 1e-6


@pytest.mark.parametrize("spec", [(4, 4, 4), (4, 4, 8)])
def test_diameter_avg_hops_equals_reference(spec):
    """4^3 takes the APSP path on the given device, 4x4x8 the host BFS
    from one cube."""
    diam, avg = PT.diameter_avg_hops(PT.pt(spec), device="cpu")
    ref_diam, ref_avg = T.diameter_avg_hops(T.pt(spec))
    assert diam == ref_diam
    assert abs(avg - ref_avg) < 1e-12


@pytest.mark.parametrize("spec", [(4, 4, 4), (4, 4, 8)])
def test_bfs_all_pairs_equals_scipy(spec):
    got = PT.bfs_all_pairs(PT.pt(spec), device="cpu")
    want = T.bfs_all_pairs(T.pt(spec))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # explicit sources keep the host BFS
    np.testing.assert_array_equal(
        PT.bfs_all_pairs(PT.pt(spec), sources=np.array([0, 5])),
        T.bfs_all_pairs(T.pt(spec), sources=np.array([0, 5])))


def test_bfs_all_pairs_maps_unreachable_to_inf():
    """Two 4^3 cubes with no optical circuits: no path between them."""
    got = PT.bfs_all_pairs(PT.Topology(PT.Pod((4, 4, 8)), []),
                           device="cpu")
    want = T.bfs_all_pairs(T.Topology(T.Pod((4, 4, 8)), []))
    assert np.isinf(want).sum() == 2 * 64 * 64
    np.testing.assert_array_equal(got, want)


def test_kernel_wrapper_takes_only_cuda_tensors():
    a, b = _inputs(8, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kmp.minplus(torch.from_numpy(a), torch.from_numpy(b))
    assert kmp.launches == 0


def test_ops_minplus_raises_on_other_devices():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="no path"):
        ops.minplus(a, a)
