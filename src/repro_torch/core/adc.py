"""ReLU-optimized 8b SAR ADC behavioural model (port of
``repro/core/adc.py``).

One ADC digitizes the CAAT-R voltage for the whole array: one conversion
per 8b x 8b MAC.  When the output feeds a ReLU, a negative sign bit lets
the SAR stop early at zero, skipping the remaining bit-cycles.  The
non-ideality is a per-chip INL profile (smooth bow + random DNL walk)
stored as a per-code offset table, sampled from an explicit
``torch.Generator``.  ``convert`` rounds half to even (``torch.round``),
as ``jnp.round`` does, so codes are bit-exact with the JAX package for the
same voltage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdcConfig:
    n_bits: int = 8
    max_inl_lsb: float = 0.0      # peak INL magnitude, in LSB
    bow_fraction: float = 0.6     # share of INL in the smooth (bow) part
    relu: bool = True             # fuse ReLU via MSB early-stop
    sar_cycles: int = 10          # bit-cycles per full conversion

    @property
    def n_codes(self) -> int:
        return 1 << self.n_bits

    @property
    def code_min(self) -> int:
        return -(1 << (self.n_bits - 1))

    @property
    def code_max(self) -> int:
        return (1 << (self.n_bits - 1)) - 1


AdcSample = dict[str, Any]


def sample_adc(gen: torch.Generator, cfg: AdcConfig) -> AdcSample:
    """One chip's INL profile as a per-code offset table (LSB)."""
    n = cfg.n_codes
    dev = gen.device
    x = torch.linspace(-1.0, 1.0, n, device=dev)
    phase = torch.rand((), generator=gen, device=dev) * 0.6 - 0.3
    bow = torch.sin(math.pi * (x + phase)) + 0.35 * x ** 3
    bow = bow / bow.abs().max()
    walk = torch.cumsum(torch.randn(n, generator=gen, device=dev), 0)
    walk = walk - (walk[0] + (walk[-1] - walk[0])
                   * torch.linspace(0.0, 1.0, n, device=dev))
    walk = walk / torch.clamp_min(walk.abs().max(), 1e-9)
    inl = cfg.max_inl_lsb * (cfg.bow_fraction * bow
                             + (1.0 - cfg.bow_fraction) * walk)
    peak = torch.clamp_min(inl.abs().max(), 1e-9)
    inl = inl * (cfg.max_inl_lsb / peak) if cfg.max_inl_lsb > 0 else inl * 0
    return {"inl_lut": inl.to(torch.float32)}


def ideal_adc(cfg: AdcConfig, device="cpu") -> AdcSample:
    return {"inl_lut": torch.zeros(cfg.n_codes, dtype=torch.float32,
                                   device=device)}


def convert(v: torch.Tensor, sample: AdcSample, cfg: AdcConfig, *,
            relu: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Digitize v in [-1, 1] (fraction of full scale) to signed codes.

    Returns (codes int32, negative fraction): the share of early-stopped
    (negative) conversions, which the energy model reads."""
    relu = cfg.relu if relu is None else relu
    ideal = v * float(1 << (cfg.n_bits - 1))
    idx = torch.clamp(torch.round(ideal), cfg.code_min, cfg.code_max).to(
        torch.int64)
    inl = sample["inl_lut"][idx - cfg.code_min]
    code = torch.clamp(torch.round(ideal + inl), cfg.code_min,
                       cfg.code_max).to(torch.int32)
    neg_frac = (code < 0).to(torch.float32).mean()
    if relu:
        code = torch.clamp_min(code, 0)
    return code, neg_frac


def adc_inl(sample: AdcSample, cfg: AdcConfig) -> np.ndarray:
    """Measured-style INL sweep (LSB), endpoint corrected (Fig. 9b)."""
    inl = sample["inl_lut"].cpu().numpy().astype(np.float64)
    x = np.arange(inl.size, dtype=np.float64)
    line = inl[0] + (inl[-1] - inl[0]) / (x[-1] - x[0]) * x
    return inl - line


def average_conversion_cycles(neg_fraction, cfg: AdcConfig):
    """Average SAR bit-cycles per conversion with ReLU early-stop:
    negative results stop after the sign bit, positive ones run all
    cycles."""
    full = float(cfg.sar_cycles)
    if not cfg.relu:
        return torch.as_tensor(full)
    return neg_fraction * 1.0 + (1.0 - neg_fraction) * full
