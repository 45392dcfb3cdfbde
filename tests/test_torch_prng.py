"""The port's Threefry stream against ``jax.random`` (partitionable
Threefry-2x32, JAX's default): keys and float32 draws bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _key_words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_seed_key_matches_prngkey(seed):
    assert prng.seed_key(seed) == _key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("n", [1, 512, 4097])
def test_split_and_uniform_bit_equal_over_chained_steps(seed, n):
    key = jax.random.PRNGKey(seed)
    pkey = prng.seed_key(seed)
    for _ in range(3):
        keys = jax.random.split(key, 4)
        pkeys = prng.split(pkey, 4)
        assert [_key_words(k) for k in keys] == pkeys
        for k, pk in zip(keys[1:], pkeys[1:]):
            ref = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
            got = prng.uniform(pk, n).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32))
        key, pkey = keys[0], pkeys[0]


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_block_equals_the_simulators_per_cycle_draws(seed):
    """``key, k1, k2, k3 = split(key, 4)`` then ``uniform(k_j, (N,))``
    once per cycle, as the reference cycle body draws them."""
    cycles, n = 5, 300
    chain = prng.key_chain(prng.seed_key(seed), cycles)
    block = prng.uniform_block(chain, n)
    assert block.shape == (cycles, 3, n) and block.dtype == torch.float32
    key = jax.random.PRNGKey(seed)
    for c in range(cycles):
        assert tuple(chain[c].tolist()) == _key_words(key)
        key, k1, k2, k3 = jax.random.split(key, 4)
        for j, k in enumerate((k1, k2, k3)):
            ref = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
            np.testing.assert_array_equal(block[c, j].numpy(), ref)


def test_seed_key_rejects_out_of_range_seeds():
    with pytest.raises(ValueError):
        prng.seed_key(-1)
    with pytest.raises(ValueError):
        prng.seed_key(2 ** 31)
