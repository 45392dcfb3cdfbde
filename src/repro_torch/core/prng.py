"""Bit-exact torch port of the ``jax.random`` calls the simulator makes.

JAX's default generator is Threefry-2x32 in *partitionable* mode
(``jax_threefry_partitionable=True``, the default since JAX 0.5):

- ``PRNGKey(s)`` is the word pair ``(0, s)``;
- ``split(key, num)[j]`` is ``threefry(key, (0, j))``;
- ``uniform(key, (N,))[i]`` takes ``(b1, b2) = threefry(key, (0, i))``
  and maps ``b1 ^ b2`` onto [0, 1) through the float32 bit pattern
  ``((b1 ^ b2) >> 9) | 0x3F800000`` minus 1.0.

The simulator's key chain (``key, k1, k2, k3 = split(key, 4)`` once per
cycle) depends only on the seed, never on simulator state. So the chain
is walked once on the host (:func:`key_chain`, Python ints) and the
three ``(N,)`` draws of a whole block of cycles come from one vectorised
pass on the device (:func:`uniform_block`).

Words are int64 tensors (or Python ints) masked to 32 bits, so one
implementation serves both, and no shift overflows 63 bits.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter ``(x0, x1)`` under key
    ``(k0, k1)``. Arguments are Python ints or broadcastable int64
    tensors holding 32-bit words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def seed_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed, as ``(k0, k1)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return 0, seed


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of ``(k0, k1)`` pairs."""
    return [threefry2x32(key[0], key[1], 0, j) for j in range(num)]


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1), exactly as ``jax.random``."""
    w = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return w.view(torch.float32) - 1.0


def uniform(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` (float32 in [0, 1))."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], 0, i)
    return _bits_to_unit(b1 ^ b2)


def key_chain(key, steps: int) -> torch.Tensor:
    """The keys the simulator holds at the start of each of ``steps``
    cycles (``key = split(key, 4)[0]`` per cycle), as a ``(steps, 2)``
    int64 tensor on the host."""
    out = torch.empty((steps, 2), dtype=torch.int64)
    k0, k1 = key
    for c in range(steps):
        out[c, 0], out[c, 1] = k0, k1
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return out


def uniform_block(keys: torch.Tensor, n: int) -> torch.Tensor:
    """For each key of a ``(B, 2)`` chain, the three draws one simulator
    cycle makes: ``uniform(split(key, 4)[j], (n,))`` for j = 1, 2, 3.
    Returns ``(B, 3, n)`` float32 on the keys' device."""
    dev = keys.device
    j = torch.arange(1, 4, dtype=torch.int64, device=dev)
    s0, s1 = threefry2x32(keys[:, 0, None], keys[:, 1, None], 0, j[None, :])
    i = torch.arange(n, dtype=torch.int64, device=dev)
    b1, b2 = threefry2x32(s0[..., None], s1[..., None], 0, i)
    return _bits_to_unit(b1 ^ b2)
