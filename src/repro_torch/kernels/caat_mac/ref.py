"""81-plane oracle for the CAAT macro tile (port of
``repro/kernels/caat_mac/ref.py``).

It does not use the 9-plane collapse the kernel path uses: it evaluates the
in-column / in-bank / in-array pipeline through ``core.caat.caat_combine``,
so a test against it also checks the collapse.
"""
from __future__ import annotations

import torch

from repro_torch.core import caat as caat_lib
from repro_torch.core import numerics


def caat_mac_ref(a_int8: torch.Tensor, w_int8: torch.Tensor, caat_sample,
                 v_fs_mac, *, act_sum: float = 128.0, w_sum: float = 128.0,
                 relu: bool = True) -> torch.Tensor:
    """One row tile [B, M] x [M, N] -> int32 codes [B, N]."""
    m = a_int8.shape[-1]
    a_bits = numerics.encode_pm1(a_int8).to(torch.float32)
    w_bits = numerics.encode_pm1(w_int8).to(torch.float32)
    v_col = torch.einsum("bmk,mni->bnki", a_bits, w_bits) / m
    v_root = caat_lib.caat_combine(v_col, caat_sample)
    fs_ratio = (m * act_sum * w_sum) / torch.as_tensor(
        v_fs_mac, dtype=torch.float32, device=a_int8.device)
    code = torch.clamp(torch.round(v_root * fs_ratio * 128.0), -128, 127)
    if relu:
        code = torch.clamp_min(code, 0)
    return code.to(torch.int32)
