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

from repro_torch.core import numerics

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


def calibrate_plane_full_scale(a_q: torch.Tensor, w_q: torch.Tensor,
                               nbits: int = 8, margin: float = 1.1
                               ) -> torch.Tensor:
    """Static per-plane ADC full scales for :func:`bitserial_matmul`: the
    per-plane |partial sum| envelope on a calibration batch, times a
    safety margin.  Returns [nbits] f32."""
    planes = numerics.encode_twos_complement_planes(a_q, nbits)
    fs = []
    for k in range(nbits):
        psum = int8_matmul_int32(planes[..., k], w_q)
        fs.append(torch.clamp_min(psum.abs().amax().to(torch.float32), 1.0))
    return torch.stack(fs) * margin


def bitserial_matmul(a_q, w_q, a_scale, w_scale, bias=None,
                     relu: bool = False, plane_adc_bits: int | None = None,
                     nbits: int = 8, plane_full_scale=None,
                     dynamic_plane_fs: bool = False) -> torch.Tensor:
    """Bit-serial-activation baseline (the paper's prior works): one pass
    per two's-complement activation bit-plane against the full int8
    weights, each plane's partial sum through its own conversion
    (optionally a ``plane_adc_bits`` ADC on a static full scale, or the
    runtime-autorange study path), shift-added in f32 from plane 0 up.

    With ``plane_adc_bits=None`` the result equals :func:`w8a8_matmul`
    while |acc| stays below 2**24; above it the f32 shift-add rounds, in
    the reference's order."""
    if plane_adc_bits is not None and plane_full_scale is None \
            and not dynamic_plane_fs:
        raise ValueError(
            "plane_adc_bits needs a static plane_full_scale (see "
            "calibrate_plane_full_scale); pass dynamic_plane_fs=True to "
            "explicitly opt into the non-deployable runtime-autorange path")
    planes = numerics.encode_twos_complement_planes(a_q, nbits)
    acc = torch.zeros((*a_q.shape[:-1], w_q.shape[1]), dtype=torch.float32,
                      device=a_q.device)
    for k in range(nbits):
        psum = int8_matmul_int32(planes[..., k], w_q).to(torch.float32)
        if plane_adc_bits is not None:
            half = 2 ** (plane_adc_bits - 1)
            if plane_full_scale is not None:
                fs = torch.as_tensor(plane_full_scale, dtype=torch.float32,
                                     device=a_q.device)
                lsb = (fs[k] if fs.ndim else fs) / half
                psum = torch.clamp(torch.round(psum / lsb), -half,
                                   half - 1) * lsb
            else:
                lsb = torch.clamp_min(psum.abs().amax(), 1e-6) / half
                psum = torch.round(psum / lsb) * lsb
        weight = -(2.0 ** (nbits - 1)) if k == nbits - 1 else 2.0 ** k
        acc = acc + weight * psum
    y = acc * (a_scale * w_scale)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y
