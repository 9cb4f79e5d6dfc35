"""W8A8 quantization utilities (port of ``repro/core/quant.py``).

Bit-exact with the JAX package: both round half-to-even
(``torch.round`` / ``jnp.round``) and divide by the scale, never multiply by
a reciprocal.  The int8 x int8 product is exact: it is accumulated in
float64 (exact below 2**53, and |acc| <= K * 128 * 127 is far below that)
because ``torch.matmul`` has no int8/int32 product on CUDA and a float32
product of int8 codes is not exact once |acc| passes 2**24.
"""
from __future__ import annotations

import dataclasses

import torch

INT8_MIN, INT8_MAX = -128, 127


def absmax_scale(x: torch.Tensor, axis=None, qmax: int = INT8_MAX
                 ) -> torch.Tensor:
    """scale s.t. x / scale fits int8; axis=None -> per-tensor."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return amax.clamp_min(1e-8) / qmax


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization."""
    return torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX).to(
        torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


@dataclasses.dataclass
class QTensor:
    """A quantized activation or KV page: int8 codes + the scale they
    carry (a scalar, or a per-token-head tensor broadcasting against the
    codes, e.g. the paged pool's [.., KVH, 1] scale)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, idx):
        """Joint gather of codes and scale along leading axes (a scalar
        scale passes through unindexed)."""
        if self.scale.ndim == 0:
            return QTensor(self.q[idx], self.scale)
        return QTensor(self.q[idx], self.scale[idx])

    def dequant(self) -> torch.Tensor:
        return dequantize(self.q, self.scale)


def quantize_to(x: "torch.Tensor | QTensor", scale) -> QTensor:
    """x -> QTensor on `scale`'s grid (no-op re-wrap when already there)."""
    if isinstance(x, QTensor):
        return x
    return QTensor(quantize(x.to(torch.float32), scale), scale)


def int8_matmul_int32(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 x (K, N) int8 -> exact int32 accumulators."""
    acc = torch.matmul(a_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.int32)


def w8a8_matmul(a_q, w_q, a_scale, w_scale, bias=None, relu: bool = False,
                out_scale=None) -> torch.Tensor:
    """The single-pass W8A8 linear: ONE epilogue over the int32
    accumulator, in the reference's order: ``acc * (a_scale * w_scale)``,
    ``+ bias``, ReLU, then ``y / out_scale`` requantization."""
    acc = int8_matmul_int32(a_q, w_q)
    y = acc.to(torch.float32) * (a_scale * w_scale)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        return quantize(y, out_scale)
    return y
