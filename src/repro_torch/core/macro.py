"""CiM macro behavioural simulation: full matmuls on the 1152x9x9 array
(port of ``repro/core/macro.py``).

``cim_matmul_sim`` runs a (B, K) x (K, N) int8 matmul the way a system
built from these macros would: K is split into row tiles of ``rows``
(1152); each tile is one macro invocation, simulated through its three
charge-sharing phases (81 bit-plane averages -> CAAT combine -> one 8b
ADC conversion per output); tiles accumulate digitally as int32 codes.
ReLU fuses into the ADC only when the reduction fits one tile.

The in-column sums of +/-1 products are exact integers in f32 (the +/-1
operands are exact even in TF32), and the averages and the CAAT combine
run in float64, rounding the root voltage to f32 once (see
``core.caat.caat_combine``); the ADC conversion is the reference's f32
arithmetic.  So the codes are those of the exactly rounded voltage, the
same on every device; the JAX package's f32 simulation differs from them
by one on a small share of the outputs of mostly padded row tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import adc as adc_lib
from repro_torch.core import caat as caat_lib
from repro_torch.core import numerics


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    rows: int = 1152               # SRAM rows per bank (reduction/conv.)
    caat: caat_lib.CaatConfig = caat_lib.CaatConfig()
    adc: adc_lib.AdcConfig = adc_lib.AdcConfig()

    @property
    def act_sum(self) -> float:
        return float(np.sum(self.caat.act_weights))   # 128 for 8b

    @property
    def w_sum(self) -> float:
        return float(np.sum(self.caat.w_weights))     # 128 for 8b


MacroSample = dict[str, Any]


def sample_chip(key, cfg: MacroConfig) -> MacroSample:
    """Draw one chip: CAAT mismatch + ADC INL, at a ``prng`` key
    (split in two, as the JAX package splits it)."""
    k_caat, k_adc = prng.split(prng.as_key(key), 2).unbind(-2)
    return {"caat": caat_lib.sample_caat(k_caat, cfg.caat),
            "adc": adc_lib.sample_adc(k_adc, cfg.adc)}


def ideal_chip(cfg: MacroConfig, device="cpu") -> MacroSample:
    return {"caat": caat_lib.ideal_caat(cfg.caat, device),
            "adc": adc_lib.ideal_adc(cfg.adc, device)}


def _one_tile(a_tile, w_tile, chip: MacroSample, cfg: MacroConfig,
              v_fs_mac, relu: bool):
    """One macro invocation on a [B, M] x [M, N] int tile: (codes [B, N]
    int32, negative fraction)."""
    m = a_tile.shape[-1]
    a_bits = numerics.encode_pm1(a_tile, cfg.caat.n_act_bits - 1).to(
        torch.float32)
    w_bits = numerics.encode_pm1(w_tile, cfg.caat.n_w_bits - 1).to(
        torch.float32)
    # In-column phase: 81 bit-plane averages v_col[b, n, k, i] in [-1, 1]:
    # sums of +/-1 products (exact in f32), averaged in float64 for the
    # float64 CAAT combine.
    v_col = torch.einsum("bmk,mni->bnki", a_bits, w_bits).to(
        torch.float64) / m
    v_root = caat_lib.caat_combine(v_col, chip["caat"])
    ideal_fs = v_fs_mac / (m * cfg.act_sum * cfg.w_sum)
    return adc_lib.convert(v_root / ideal_fs, chip["adc"], cfg.adc,
                           relu=relu)


def cim_matmul_sim(a_int8: torch.Tensor, w_int8: torch.Tensor,
                   chip: MacroSample, v_fs_mac, cfg: MacroConfig,
                   relu: bool = True) -> tuple[torch.Tensor, dict]:
    """Full CiM matmul with row tiling and digital inter-tile
    accumulation.  Returns (acc codes [B, N] f32 in ADC-code units,
    stats); multiply by v_fs_mac / 2^(n_bits-1) for MAC units."""
    b, k = a_int8.shape
    k2, n = w_int8.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {a_int8.shape} x "
                         f"{w_int8.shape}")
    rows = cfg.rows
    n_tiles = -(-k // rows)
    pad = n_tiles * rows - k
    v_fs_mac = torch.as_tensor(v_fs_mac, dtype=torch.float32,
                               device=a_int8.device)
    a_p = torch.nn.functional.pad(a_int8.to(torch.int32), (0, pad))
    w_p = torch.nn.functional.pad(w_int8.to(torch.int32), (0, 0, 0, pad))
    fused_relu = relu and n_tiles == 1
    acc = torch.zeros((b, n), dtype=torch.int32, device=a_int8.device)
    negs = torch.zeros((), dtype=torch.float32, device=a_int8.device)
    for t in range(n_tiles):   # the reference's lax.scan over row tiles
        codes, neg = _one_tile(a_p[:, t * rows:(t + 1) * rows],
                               w_p[t * rows:(t + 1) * rows], chip, cfg,
                               v_fs_mac, fused_relu)
        acc = acc + codes
        negs = negs + neg
    if relu and not fused_relu:
        acc = torch.clamp_min(acc, 0)
    stats = {
        "n_conversions": float(n_tiles * b * n),
        "neg_fraction": negs / n_tiles,
        "relu_fused": 1.0 if fused_relu else 0.0,
        "n_tiles": float(n_tiles),
    }
    return acc.to(torch.float32), stats


def nominal_config(rows: int = 1152, relu: bool = True) -> MacroConfig:
    """The fabricated chip's nominal non-idealities (calibrated so that
    ~70% of sampled chips reach >= 7b CAAT accuracy and the ADC shows max
    |INL| = 1.2 LSB, as Fig. 9 measures)."""
    return MacroConfig(
        rows=rows,
        caat=caat_lib.CaatConfig(sigma_unit=0.0014, c2c_stage_gamma=0.0007,
                                 gain_sigma=0.001, offset_sigma=0.0005),
        adc=adc_lib.AdcConfig(max_inl_lsb=1.2, relu=relu),
    )


def default_v_fs(a_abs_max: float, w_abs_max: float, k: int, rows: int,
                 utilization: float = 0.25) -> float:
    """Static full-scale heuristic when no calibration data exists:
    ``utilization`` x the worst-case one-tile MAC."""
    return float(utilization * a_abs_max * w_abs_max * min(k, rows))
