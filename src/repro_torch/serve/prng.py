"""Counter-based random numbers that match ``jax.random`` bit for bit
(the port's own copy of the functions the serving engines use).

The JAX package samples with ``jax.random`` under its defaults:
``threefry2x32`` keys, ``jax_threefry_partitionable=True`` (a draw of
shape ``S`` hashes the 64-bit flat index of each element, high word
first) and 32-bit seeds.  This module reproduces those draws with torch
integer ops, so a sampled token stream is the same in both packages at
the same key:

* a key is a ``uint32[2]`` pair held as an int64 tensor ``[..., 2]``
  (values in ``[0, 2**32)``); leading dimensions are independent keys,
  one per row;
* every 32-bit operation runs on int64 and is masked back to 32 bits;
* ``uniform`` turns 23 random mantissa bits into a float in ``[1, 2)``
  and subtracts one; ``gumbel`` is ``-log(-log(u))`` over
  ``uniform(tiny, 1)`` (JAX's ``mode="low"``); ``categorical`` takes the
  first maximum of ``gumbel + logits``.

The integer draws (keys, bits, ``uniform``, ``randint``) are exact.
``gumbel`` goes through ``log``, which may round differently from XLA's
by an ulp, so a ``categorical`` draw equals JAX's unless two classes tie
within that rounding.  ``geometric`` (the training data's offsets) goes
through ``log`` too: a draw equals JAX's unless ``log(u) / log1p(-p)``
lies within that rounding of an integer.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, *, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is
    taken modulo 2**32 into the key's low word."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A key as the int64 ``[..., 2]`` tensor this module works on: a
    tensor, or a ``uint32[2]`` array such as
    ``np.asarray(jax.random.key_data(k))``."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64)
    else:
        k = torch.from_numpy(np.asarray(key, dtype=np.uint32).astype(
            np.int64))
    if k.shape[-1] != 2:
        raise ValueError(f"a key is a uint32[2] pair, got shape "
                         f"{tuple(k.shape)}")
    return k if device is None else k.to(device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``: int64 tensors (or ints) holding uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per key: ``key`` ``[..., 2]``, ``data`` an
    int or an integer tensor broadcast against the key's leading dims
    (taken modulo 2**32, as JAX's cast to uint32).  An int stays on the
    host: no copy to the device."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key: ``[num, 2]``."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[0], key[1], 0, lo)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key: ``key``
    ``[..., 2]`` -> int64 ``[..., *shape]`` in ``[0, 2**32)``.  Element
    ``i`` (flat) hashes the counter ``(0, i)``; both output words are
    XORed."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError("a draw of 2**32 or more elements needs the "
                         "counter's high word")
    lead = key.shape[:-1]
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(
        (1,) * len(lead) + shape)
    k0 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k1 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    o0, o1 = threefry2x32(k0, k1, 0, lo)
    return o0 ^ o1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``[..., *shape]`` in
    ``[minval, maxval)``.  The bounds and their span are rounded to
    float32 on the host, as JAX computes them."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(
        torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"``."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis with one key per row:
    ``key`` ``[..., 2]``, float32 ``logits`` ``[..., V]`` -> int64
    ``[...]`` (the first maximum of ``gumbel + logits``)."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` to int32 for one key, with ``minval`` and
    ``maxval`` in int32 range: JAX's two-draw modulus (each product and
    sum wraps at 32 bits)."""
    k_hi, k_lo = split(key, 2)
    higher = random_bits(k_hi, shape)
    lower = random_bits(k_lo, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    offset = (((higher % span) * mult) & MASK)
    offset = ((offset + lower % span) & MASK) % span
    return (offset + minval).to(torch.int32)


INT32_MAX = 2**31 - 1


def geometric(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.geometric`` to int32 for one key: ``floor(log(u) /
    log1p(-p)) + 1`` over ``uniform`` in f32, ``log1p(-p)`` rounded to f32
    on the host.  The cast saturates as XLA's does (``u = 0`` gives
    ``+inf``, so ``INT32_MAX``)."""
    log_q = float(np.float32(np.log1p(-np.float64(np.float32(p)))))
    g = torch.floor(torch.log(uniform(key, shape)) / log_q) + 1.0
    big = g >= 2.0**31
    return torch.where(big, INT32_MAX,
                       torch.where(big, 0.0, g).to(torch.int32))
