"""JAX's ``threefry2x32`` key API on torch tensors, bit for bit.

The solve draws random numbers inside itself (MIS tie-breaks and
bail-outs, the Newton initial guesses, the restart draw), so the port
must draw exactly the numbers ``jax.random`` draws to follow the same
trajectory.  This module reproduces, with ``jax_threefry_partitionable``
on (JAX's default):

* :func:`PRNGKey` — a raw key ``[seed >> 32, seed & 0xFFFFFFFF]``;
* :func:`split` — the fold-like split: key ``i`` is the threefry hash of
  the 64-bit counter ``i`` (high word, low word);
* :func:`uniform` — the threefry hash of the flat index of each element;
  f32 takes ``bits1 ^ bits2`` and keeps 23 mantissa bits, f64 takes
  ``(bits1 << 32) | bits2`` and keeps 52.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words.
torch has no uint32 shifts on every backend, so the 32-bit arithmetic
runs in int64 with ``& 0xFFFFFFFF`` after every add and shift.  Keys are
made on the CPU by default; the draws are small vectors, and
:func:`uniform` moves its result to ``device``.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry2x32(k1: torch.Tensor, k2: torch.Tensor,
                  x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words;
    the unrolled form of JAX's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key for an integer seed (``jax.random.PRNGKey``)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash_counts(key: torch.Tensor, count: int):
    """Hash the 64-bit counters ``0 .. count-1`` under ``key``."""
    lo = torch.arange(count, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    return _threefry2x32(key[0], key[1], hi, lo & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: an int64 ``(num, 2)`` tensor.

    The few hashes run on Python integers (the same arithmetic as the
    tensor path), which costs a fraction of the ~100 tiny tensor ops the
    tensor path would launch for every split in the solve loop."""
    k1, k2 = (int(v) for v in key.tolist())
    rows = [_threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(num)]
    return torch.tensor(rows, dtype=torch.int64, device=key.device)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float64,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on ``[0, 1)``.

    The mantissa bits are taken as JAX takes them; ``m * 2**-nmant``
    equals JAX's ``bitcast(m | bits(1.0)) - 1`` exactly, since both are
    exact in the target type.
    """
    shape = tuple(shape)
    b1, b2 = _hash_counts(key, math.prod(shape))
    if dtype == torch.float64:
        m = (b1 << 20) | (b2 >> 12)       # ((b1 << 32) | b2) >> 12
        out = m.to(torch.float64) * 2.0 ** -52
    elif dtype == torch.float32:
        m = (b1 ^ b2) >> 9
        out = m.to(torch.float32) * 2.0 ** -23
    else:
        raise TypeError(f"uniform supports float32/float64, got {dtype}")
    out = out.reshape(shape)
    return out if device is None else out.to(device)
