"""Output-based fine-tune compensation (paper section II.C, Fig. 5b; port
of ``repro/core/calibration.py``).

The dominant non-idealities distort a layer's output approximately
linearly, so one calibration pass after tape-out fits

    y_hat = (sigma0 / sigma1) * y1 + (mu0 - (sigma0 / sigma1) * mu1)

from the chip output y1 and the ideal output y0, per tensor (the paper's
scheme) or per output channel.  ``torch.std(..., correction=0)`` is the
population std, as ``jnp.std`` is.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FineTuneParams:
    gain: torch.Tensor    # sigma0 / sigma1      (scalar or [N])
    offset: torch.Tensor  # mu0 - gain * mu1     (scalar or [N])

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.gain + self.offset

    def fold_into(self, scale, bias):
        """Fold into an epilogue y = scale*acc + bias, so that
        apply(scale*acc + bias) == folded_scale*acc + folded_bias."""
        return self.gain * scale, self.gain * bias + self.offset


def fit_finetune(ideal: torch.Tensor, measured: torch.Tensor,
                 granularity: str = "per_tensor", eps: float = 1e-6
                 ) -> FineTuneParams:
    """Fit the affine correction from one calibration pass over [..., N]
    outputs: 'per_tensor' (the paper) or 'per_channel' (statistics over
    every axis but the last)."""
    if granularity == "per_tensor":
        dims = tuple(range(ideal.ndim))
    elif granularity == "per_channel":
        dims = tuple(range(ideal.ndim - 1))
    else:
        raise ValueError(f"unknown granularity: {granularity!r}")
    mu0 = ideal.mean(dim=dims)
    mu1 = measured.mean(dim=dims)
    s0 = ideal.std(dim=dims, correction=0)
    s1 = measured.std(dim=dims, correction=0)
    gain = s0 / torch.clamp_min(s1, eps)
    return FineTuneParams(gain=gain, offset=mu0 - gain * mu1)


def identity_finetune(device="cpu") -> FineTuneParams:
    return FineTuneParams(gain=torch.tensor(1.0, device=device),
                          offset=torch.tensor(0.0, device=device))
