"""ReLU-optimized 8b SAR ADC behavioural model (port of
``repro/core/adc.py``).

One ADC digitizes the CAAT-R voltage for the whole array: one conversion
per 8b x 8b MAC.  When the output feeds a ReLU, a negative sign bit lets
the SAR stop early at zero, skipping the remaining bit-cycles.  The
non-ideality is a per-chip INL profile (smooth bow + random DNL walk)
stored as a per-code offset table, sampled at a ``prng`` key as the JAX
package samples it (a ``[..., 2]`` batch of keys samples a batch of
tables).  ``convert`` rounds half to even (``torch.round``), as
``jnp.round`` does, so codes are bit-exact with the JAX package for the
same voltage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import prng


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


def _linspace(start, stop, n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` over a new last axis, in the f32
    steps XLA:CPU compiles it to: ``s = i * f32(1 / (n - 1))``, then
    ``fma(i, stop * f32(1 / (n - 1)), start * (1 - s))``, and ``stop``
    itself last."""
    start = torch.as_tensor(start, dtype=torch.float32)[..., None]
    stop = torch.as_tensor(stop, dtype=torch.float32)[..., None]
    inv = float(np.float32(1.0) / np.float32(n - 1))
    i = torch.arange(n - 1, dtype=torch.float32, device=stop.device)
    head = (i.to(torch.float64) * (stop * inv) + start * (1.0 - i * inv))
    return torch.cat([head.to(torch.float32), stop], dim=-1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` over the last axis in XLA:CPU's f32 order: running
    sums within blocks of 16, plus the running sum of the earlier blocks'
    totals."""
    n = x.shape[-1]

    def running(v):
        out = [v[..., 0]]
        for j in range(1, v.shape[-1]):
            out.append(out[-1] + v[..., j])
        return torch.stack(out, dim=-1)

    if n <= 16:
        return running(x)
    pad = -n % 16
    blocks = running(torch.nn.functional.pad(x, (0, pad)).unflatten(
        -1, (-1, 16)))
    before = torch.nn.functional.pad(_cumsum(blocks[..., -1])[..., :-1],
                                     (1, 0))
    return (blocks + before[..., None]).flatten(-2)[..., :n]


def sample_adc(key, cfg: AdcConfig) -> AdcSample:
    """One chip's INL profile as a per-code offset table (LSB): at a
    ``prng`` key in JAX's steps (split into bow (unused), walk and
    phase keys) on the key's device."""
    n = cfg.n_codes
    _, k_walk, k_phase = prng.split(prng.as_key(key), 3).unbind(-2)
    x = _linspace(-1.0, 1.0, n).to(k_walk.device)
    phase = prng.uniform(k_phase, (), -0.3, 0.3)[..., None]
    steps = prng.normal(k_walk, (n,))
    # sin rounded once from float64 (torch's f32 sin is not correctly
    # rounded); x * x * x as JAX's integer power.
    bow = torch.sin((math.pi * (x + phase)).to(torch.float64)).to(
        torch.float32) + 0.35 * (x * x * x)
    bow = bow / bow.abs().amax(-1, keepdim=True)
    walk = _cumsum(steps)
    walk = walk - _linspace(walk[..., 0], walk[..., -1], n)
    walk = walk / torch.clamp_min(walk.abs().amax(-1, keepdim=True), 1e-9)
    inl = cfg.max_inl_lsb * (cfg.bow_fraction * bow
                             + (1.0 - cfg.bow_fraction) * walk)
    peak = torch.clamp_min(inl.abs().amax(-1, keepdim=True), 1e-9)
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
