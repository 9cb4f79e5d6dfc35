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
  first maximum of ``gumbel + logits``;
* ``normal`` is ``sqrt(2) * erf_inv(u)`` over ``uniform(nextafter(-1,
  0), 1)``, with ``erf_inv`` and its ``log1p`` written out as XLA's f32
  CPU code computes them (Giles' polynomials, Cephes' ``log1p`` and
  ``log``), each multiply-add fused as XLA:CPU fuses it.

The integer draws (keys, bits, ``uniform``, ``randint``) are exact, and
so is ``normal``: it equals ``jax.random.normal`` on the CPU on every
draw tested (``tests/test_torch_paper_figs.py``; ``torch.special.erfinv``
is up to 91 ulp away).  Its fused multiply-adds round the exact product
plus the addend once in float64 and again to f32, which can round a
result one ulp from the fused operation's once in about 2**29
operations; its ``sqrt`` and divisions go through float64 for the same
reason (torch's f32 ``sqrt`` on the CPU is not correctly rounded).
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
# A CPU pass over more elements than this falls out of the caches: in
# chunks of it threefry takes half the time and erf_inv a third, on one
# thread.  On the card one pass over the whole draw is faster.
_CPU_CHUNK = 1 << 16


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


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``: int64 tensors holding uint32 values (the
    counters may be ints), broadcast together.  Returns the two output
    words.  The rounds update two buffers in place: a draw of millions
    of elements would otherwise spend most of its time allocating."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    shape = torch.broadcast_shapes(x0.shape, x1.shape)
    x0 = x0.expand(shape).contiguous()
    x1 = x1.expand(shape).clone()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=tmp).bitwise_and_(MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
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
    """``jax.random.split(key, num)`` per key: ``[..., 2]`` ->
    ``[..., num, 2]`` (``[num, 2]`` for one key)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, lo)
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
    lead = tuple(key.shape[:-1])
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(
        (1,) * len(lead) + shape)
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))

    def bits(counters):
        o0, o1 = threefry2x32(k0, k1, 0, counters)
        return o0 ^ o1
    if lead:
        return bits(lo)
    return _by_chunks(lambda c: bits(c).reshape(c.shape), lo)


def _by_chunks(fn, x: torch.Tensor) -> torch.Tensor:
    """An elementwise ``fn`` of ``x``, in chunks of the flattened ``x``
    on the CPU (see ``_CPU_CHUNK``), at once elsewhere."""
    if x.device.type != "cpu" or x.numel() <= _CPU_CHUNK:
        return fn(x)
    flat = x.reshape(-1)
    return torch.cat([fn(flat[i:i + _CPU_CHUNK])
                      for i in range(0, flat.numel(), _CPU_CHUNK)]).reshape(
        x.shape)


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as XLA:CPU contracts it: the
    product of two f32 values is exact in float64 (see the module's note
    on the sum's rounding)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``[..., *shape]`` in
    ``[minval, maxval)``.  The bounds and their span are rounded to
    float32 on the host, as JAX computes them, and ``floats * span +
    minval`` is one fused multiply-add, as XLA:CPU compiles it (separate
    roundings differ on half the draws where the span is not a power of
    two)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(
        torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    if np.frexp(span)[0] == 0.5:      # a power of two: the product is exact
        out = floats * span + float(lo)
    else:
        out = _fma(floats, span, float(lo))
    return torch.clamp_min(out, float(lo))


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's single-precision erf_inv (Giles), one 9-term polynomial in w - 2.5
# for w = -log1p(-x * x) < 5 and one in sqrt(w) - 3 otherwise.
_ERFINV_SMALL = tuple(map(_f32, (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)))
_ERFINV_LARGE = tuple(map(_f32, (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682)))
# Cephes' log1p rational for |x| < sqrt(2) - 1, as XLA emits it.
_LOG1P_NUM = tuple(map(_f32, (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)))
_LOG1P_DEN = tuple(map(_f32, (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)))
# Cephes' log polynomial over the mantissa in [sqrt(1/2), sqrt(2)).
_LOG_P = tuple(map(_f32, (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``coeffs[0] * x**(n-1) + ...`` by fused multiply-adds, in place
    (a draw of millions of elements would otherwise spend its time
    allocating)."""
    x64 = x.to(torch.float64)
    acc = torch.empty_like(x64)
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        torch.mul(p, x64, out=acc)
        p.copy_(acc.add_(c))
    return p


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` for positive finite ``x``: the exponent and
    a mantissa in [sqrt(1/2), sqrt(2)), Cephes' polynomial over it."""
    x = torch.clamp_min(x, TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    y = _fma(m, _LOG_P[0], _LOG_P[1])
    y1 = _fma(m, _LOG_P[3], _LOG_P[4])
    y2 = _fma(m, _LOG_P[6], _LOG_P[7])
    y = _fma(y, m, _LOG_P[2])
    y1 = _fma(y1, m, _LOG_P[5])
    y2 = _fma(y2, m, _LOG_P[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _LOG_Q1 * e)
    m = _fma(m2, -0.5, m) + y
    return m + _LOG_Q2 * e


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` for ``x > -1``: Cephes' rational for
    ``|x| < sqrt(2) - 1``, ``log(1 + x)`` otherwise (computed on those
    elements only)."""
    x2 = x * x
    ratio = (_horner(x, _LOG1P_NUM).to(torch.float64)
             / _horner(x, _LOG1P_DEN)).to(torch.float32)
    out = x + _fma(x2, -0.5, (x * x2) * ratio)
    far = x.abs() >= _f32(0.41421356237309504880)
    out[far] = _xla_log(x[far] + 1.0)
    return out


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (``jax.lax.erf_inv``) for ``|x| <= 1``."""
    return _by_chunks(_erf_inv, x)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -_xla_log1p(x * -x)
    p = _horner(w - 2.5, _ERFINV_SMALL)
    far = w >= 5.0
    t = torch.sqrt(w[far].to(torch.float64)).to(torch.float32) - 3.0
    p[far] = _horner(t, _ERFINV_LARGE)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_SQRT2 = _f32(np.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``[..., *shape]``."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))


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
    k_hi, k_lo = split(key, 2).unbind(-2)
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
