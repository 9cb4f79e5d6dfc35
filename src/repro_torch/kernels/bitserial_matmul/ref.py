"""Oracles for the bit-serial baseline (exact integer planes, f32
shift-add in the reference's order)."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitserial_matmul.ops import \
    bitplane_matmul_plain as bitplane_matmul_ref


def bitserial_matmul_ref(a_q, w_q, a_scale, w_scale, bias=None,
                         relu: bool = False, nbits: int = 8) -> torch.Tensor:
    acc = torch.zeros((a_q.shape[0], w_q.shape[1]), dtype=torch.float32,
                      device=a_q.device)
    for k in range(nbits):
        psum = bitplane_matmul_ref(a_q, w_q, k).to(torch.float32)
        weight = -(2.0 ** (nbits - 1)) if k == nbits - 1 else 2.0 ** k
        acc = acc + weight * psum
    y = acc * (a_scale * w_scale[None, :])
    if bias is not None:
        y = y + bias[None, :]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y
