"""Eq.(1) +/-1-bit signed numeric representation (port of
``repro/core/numerics.py``).

An N-bit signed integer x is represented with N+1 bits, each in {-1, +1}:

    x = sum_{i=1}^{N-1} n_i * 2^{i-1} + (n_{0+} + n_{0-}) * 2^{-1}

For N = 8 the MSB-first ladder weights are (64, 32, 16, 8, 4, 2, 1, 0.5,
0.5).  The representation is multiplicative: a * w is the ladder-weighted
sum of the 81 one-bit products a_k * w_i, each in {-1, +1} -- the XNOR the
10T1C cell computes in the charge domain.  Everything here is integer
arithmetic and bit-exact with the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

BIT_WEIGHTS_8B: tuple[float, ...] = (64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0,
                                     0.5, 0.5)
N_BITS_8B = len(BIT_WEIGHTS_8B)  # 9
INT8_MIN, INT8_MAX = -128, 127


def bit_weights(nbits: int = 8) -> np.ndarray:
    """Ladder weights for the (nbits+1)-bit +/-1 representation, MSB
    first."""
    if nbits < 2:
        raise ValueError(f"nbits must be >= 2, got {nbits}")
    powers = [2.0 ** i for i in range(nbits - 2, -1, -1)]
    return np.asarray(powers + [0.5, 0.5], dtype=np.float32)


def encode_pm1(x: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Signed integers -> +/-1 bit vectors on a new trailing axis (int8,
    ``x.shape + (nbits + 1,)``) with ``(bits * bit_weights).sum(-1) ==
    x``."""
    half = 2 ** (nbits - 1)
    u = x.to(torch.int32) + half                 # in [0, 2^nbits - 1]
    integer = u >> 1                             # top nbits-1 binary bits
    frac = u & 1                                 # the 0.5-weight bit
    shifts = torch.arange(nbits - 2, -1, -1, dtype=torch.int32,
                          device=x.device)
    tbits = (integer[..., None] >> shifts) & 1   # MSB-first
    t = torch.cat([tbits, frac[..., None], torch.zeros_like(frac[..., None])],
                  dim=-1)
    return (2 * t - 1).to(torch.int8)


def decode_pm1(bits: torch.Tensor, nbits: int = 8) -> torch.Tensor:
    """Inverse of :func:`encode_pm1`."""
    w = torch.as_tensor(bit_weights(nbits), device=bits.device)
    val = (bits.to(torch.float32) * w).sum(-1)
    return torch.round(val).to(torch.int32)


def encode_twos_complement_planes(x: torch.Tensor, nbits: int = 8
                                  ) -> torch.Tensor:
    """Two's-complement {0,1} bit-planes, LSB first: ``x.shape +
    (nbits,)`` int8 with x = -b_{N-1} 2^{N-1} + sum_{k<N-1} b_k 2^k."""
    x = x.to(torch.int32)
    u = torch.where(x < 0, x + (1 << nbits), x)
    shifts = torch.arange(nbits, dtype=torch.int32, device=x.device)
    return ((u[..., None] >> shifts) & 1).to(torch.int8)


def decode_twos_complement_planes(planes: torch.Tensor, nbits: int = 8
                                  ) -> torch.Tensor:
    weights = 2 ** torch.arange(nbits, dtype=torch.int32,
                                device=planes.device)
    weights[nbits - 1] *= -1
    return (planes.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def exact_int_matmul(a_int: torch.Tensor, w_int: torch.Tensor
                     ) -> torch.Tensor:
    """int32-accurate integer matmul oracle (..., K) x (K, N) -> (..., N).
    The product is taken in float64, exact below 2**53 (torch has no int8
    GEMM on CUDA)."""
    acc = torch.matmul(a_int.to(torch.int8).to(torch.float64),
                       w_int.to(torch.int8).to(torch.float64))
    return acc.to(torch.int32)
