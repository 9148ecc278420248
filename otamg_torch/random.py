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
made on the CPU by default; the draws are small vectors made on the
host, and :func:`to_device` moves them to the card through pinned
memory without blocking the host (a copy from pageable memory would
wait for the stream first).

The AMG setup's draws are fixed by its key and the static level sizes,
so :func:`setup_draws` makes all of them at once, before the setup runs
(:func:`mis_draws` is one level's).
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
    """Hash the 64-bit counters ``0 .. count-1`` under ``key``; one
    counter under a host key is hashed on Python integers, as
    :func:`split` hashes."""
    if count == 1 and not key.is_cuda:
        k1, k2 = (int(v) for v in key.tolist())
        return tuple(torch.tensor([v], dtype=torch.int64)
                     for v in _threefry2x32(k1, k2, 0, 0))
    lo = torch.arange(count, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    return _threefry2x32(key[0], key[1], hi, lo & _MASK)


def _split_words(k1: int, k2: int, num: int) -> list:
    """The keys of ``split`` as ``(k1, k2)`` pairs of Python integers."""
    return [_threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(num)]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: an int64 ``(num, 2)`` tensor.

    The few hashes run on Python integers (the same arithmetic as the
    tensor path), which costs a fraction of the ~100 tiny tensor ops the
    tensor path would launch for every split in the solve loop."""
    k1, k2 = (int(v) for v in key.tolist())
    return torch.tensor(_split_words(k1, k2, num), dtype=torch.int64,
                        device=key.device)


def to_device(x: torch.Tensor, device=None) -> torch.Tensor:
    """A host tensor on ``device``: to a card through a pinned copy that
    does not block the host; ``x`` itself for ``None``."""
    if device is None:
        return x
    device = torch.device(device)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


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
    return to_device(out.reshape(shape), device)


def _uniforms_f32(draws) -> torch.Tensor:
    """f32 ``uniform`` draws of several keys in one hash: ``draws`` is a
    list of ``((k1, k2), size)``; the result is their concatenation."""
    k1 = torch.tensor([k[0] for k, size in draws for _ in range(size)],
                      dtype=torch.int64)
    k2 = torch.tensor([k[1] for k, size in draws for _ in range(size)],
                      dtype=torch.int64)
    lo = torch.cat([torch.arange(size, dtype=torch.int64)
                    for _, size in draws])
    b1, b2 = _threefry2x32(k1, k2, lo >> 32, lo & _MASK)
    return ((b1 ^ b2) >> 9).to(torch.float32) * 2.0 ** -23


def _mis_keys(k1: int, k2: int, n: int) -> list:
    """One MIS call's draws: ``kb, kt = split(key)``; the tie-breaks
    come from ``kt``, the bail-out scores from ``kb``."""
    kb, kt = _split_words(k1, k2, 2)
    return [(kt, n), (kb, n)]


def _scale_ties(flat: torch.Tensor, sizes) -> torch.Tensor:
    """Each level's tie-breaks scaled by 0.1 in f32, as
    ``otamg/amg/graph.py::mis_dense`` draws them."""
    out, off = [], 0
    for n in sizes:
        out += [torch.tensor(0.1, dtype=torch.float32) * flat[off:off + n],
                flat[off + n:off + 2 * n]]
        off += 2 * n
    return torch.cat(out) if out else flat


def mis_draws(key: torch.Tensor, n: int) -> torch.Tensor:
    """The draws of ``mis_dense(As, active, key)`` on ``n`` nodes, as an
    f32 ``(2, n)`` host tensor: the tie-breaks ``0.1 * uniform(kt)`` and
    the bail-out scores ``uniform(kb)``."""
    k1, k2 = (int(v) for v in key.tolist())
    return _scale_ties(_uniforms_f32(_mis_keys(k1, k2, n)), [n]).view(2, n)


def setup_draws(key: torch.Tensor, sizes) -> torch.Tensor:
    """Every draw of a dense chain's coarsening steps from ``key``, the
    chain's key: step ``l`` coarsens a level of ``sizes[l]`` nodes with
    the key ``sub`` of ``key, sub = split(key)``, and its
    :func:`mis_draws` of ``sub`` follow those of step ``l - 1`` in one
    flat f32 host tensor of ``2 * sum(sizes)`` values, made by one hash
    pass."""
    k1, k2 = (int(v) for v in key.tolist())
    draws = []
    for n in sizes:
        (k1, k2), sub = _split_words(k1, k2, 2)
        draws += _mis_keys(*sub, n)
    if not draws:
        return torch.zeros(0, dtype=torch.float32)
    return _scale_ties(_uniforms_f32(draws), sizes)
