"""Analytic energy / area / latency model of the 65nm macro (Fig. 7, Fig.
8, Table I; port of ``repro/core/energy.py``).

Numpy only.  Two layers:

1. An operating-point model: ``P(V, f_adc) = c_dyn * V^p * f_adc + c_leak
   * V^3`` fitted to Table I's three measured points; throughput is
   structural (the ADC bounds the pipeline at f_adc / sar_cycles
   conversions per second, 1024 8b ops each).
2. A per-conversion component split {array, caat, adc, digital, periph}:
   the ADC share (8%) and area share (3%) are the paper's, the rest is
   inferred so that its comparative claims hold together (8x ADC energy
   vs one conversion per activation bit, ~2x from ReLU early-stop, 1.6x
   macro efficiency vs the parallel-activation baseline).

Every figure it returns is the model of the silicon macro, not a
measurement of the machine running this code.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import caat as caat_lib

SAR_CYCLES = 10
OPS_PER_CONVERSION = 1024          # 2 ops x 512 active rows per conversion
ADC_CLOCK_DIVIDER = 2              # f_adc = f_main / 2

# Measured operating points from Table I: (v_dd, f_main_hz, tops_per_w)
TABLE1_POINTS = (
    (1.00, 1.00e9, 3.53),
    (0.80, 0.70e9, 10.1),
    (0.76, 0.24e9, 10.3),
)

# Per-conversion energy shares at 1.0 V / 1 GHz (ADC 8% is the paper's).
ENERGY_SHARES = {
    "array": 0.55,
    "caat": 0.12,
    "adc": 0.08,      # measured WITH ReLU early-stop
    "digital": 0.17,
    "periph": 0.08,
}

# Area shares; ADC 3% is the paper's number.
AREA_SHARES = {
    "sram_array": 0.58,
    "caat": 0.12,
    "adc": 0.03,
    "digital": 0.15,
    "periph": 0.12,
}

# Parallel-activation-input baseline (Fig. 1b), per component.
BASELINE_FACTORS = {
    "array": 1.0,
    "caat": 1.35,
    "adc": 8.0,        # 8 conversions per 8b MAC
    "digital": 1.30,   # + digital shift-and-add
    "periph": 1.0,
}


def throughput_ops(f_main_hz: float) -> float:
    """8b-op/s at a main clock (ADC-limited pipeline)."""
    f_adc = f_main_hz / ADC_CLOCK_DIVIDER
    return f_adc / SAR_CYCLES * OPS_PER_CONVERSION


@functools.lru_cache(maxsize=1)
def _power_fit() -> tuple[float, float, float]:
    """Fit P = c_dyn * V^p * f_adc + c_leak * V^3 to Table I."""
    pts = []
    for v, f_main, tops_w in TABLE1_POINTS:
        p_watt = throughput_ops(f_main) / (tops_w * 1e12)
        pts.append((v, f_main / ADC_CLOCK_DIVIDER, p_watt))
    best = None
    for p in np.linspace(2.0, 7.0, 101):
        a = np.array([[v**p * f, v**3] for v, f, _ in pts])
        b = np.array([pw for _, _, pw in pts])
        coef, *_ = np.linalg.lstsq(a, b, rcond=None)
        coef = np.maximum(coef, 0.0)
        pred = a @ coef
        err = float(np.sum((np.log(pred + 1e-15) - np.log(b)) ** 2))
        if best is None or err < best[0]:
            best = (err, p, float(coef[0]), float(coef[1]))
    _, p, c_dyn, c_leak = best
    return p, c_dyn, c_leak


def power_watts(v_dd: float, f_main_hz: float) -> float:
    p, c_dyn, c_leak = _power_fit()
    f_adc = f_main_hz / ADC_CLOCK_DIVIDER
    return c_dyn * v_dd**p * f_adc + c_leak * v_dd**3


def tops_per_watt(v_dd: float, f_main_hz: float) -> float:
    return throughput_ops(f_main_hz) / power_watts(v_dd, f_main_hz) / 1e12


def energy_per_conversion_joules(v_dd: float = 1.0,
                                 f_main_hz: float = 1e9) -> float:
    f_adc = f_main_hz / ADC_CLOCK_DIVIDER
    return power_watts(v_dd, f_main_hz) / (f_adc / SAR_CYCLES)


@dataclasses.dataclass(frozen=True)
class MacroEnergyReport:
    total_per_conversion_j: float
    components_j: dict
    baseline_components_j: dict
    adc_ratio: float               # baseline ADC energy / ours     (~8x)
    relu_early_stop_factor: float  # ADC energy saved by early-stop (~2x)
    macro_efficiency_ratio: float  # baseline total / ours          (~1.6x)


def breakdown(v_dd: float = 1.0, f_main_hz: float = 1e9,
              neg_fraction: float = 0.55) -> MacroEnergyReport:
    e_conv = energy_per_conversion_joules(v_dd, f_main_hz)
    comps = {k: s * e_conv for k, s in ENERGY_SHARES.items()}
    avg_cycles = neg_fraction * 1.0 + (1.0 - neg_fraction) * SAR_CYCLES
    base = {k: comps[k] * BASELINE_FACTORS[k] for k in comps}
    ours_total = sum(comps.values())
    return MacroEnergyReport(
        total_per_conversion_j=ours_total,
        components_j=comps,
        baseline_components_j=base,
        adc_ratio=base["adc"] / comps["adc"],
        relu_early_stop_factor=SAR_CYCLES / avg_cycles,
        macro_efficiency_ratio=sum(base.values()) / ours_total,
    )


def latency_breakdown_ns(f_main_hz: float = 1e9) -> dict:
    """One-MAC latency through the pipeline (Fig. 8 right)."""
    t_main = 1e9 / f_main_hz
    t_adc_cycle = t_main * ADC_CLOCK_DIVIDER
    return {
        "in_column_ns": 1.0 * t_main,
        "in_bank_ns": 1.0 * t_main,
        "in_array_ns": 1.0 * t_main,
        "adc_ns": SAR_CYCLES * t_adc_cycle,
        "digital_ns": 2.0 * t_main,
    }


def area_breakdown_mm2(total_mm2: float = 1.0) -> dict:
    return {k: s * total_mm2 for k, s in AREA_SHARES.items()}


def capacitor_area_curve(bit_widths=(4, 5, 6, 7, 8, 9, 10)) -> dict:
    """Fig. 7(a): total CAAT-L capacitance, binary baseline vs hybrid."""
    return {
        "bits": list(bit_widths),
        "binary_C": [caat_lib.capacitor_total_binary(b) for b in bit_widths],
        "hybrid_C": [caat_lib.capacitor_total_hybrid(b) for b in bit_widths],
    }


def workload_energy_joules(n_conversions: float, neg_fraction: float = 0.55,
                           relu_fused: bool = True, v_dd: float = 1.0,
                           f_main_hz: float = 1e9) -> float:
    """Modelled macro energy for a layer or network from its conversion
    count and ReLU statistics."""
    e_conv = energy_per_conversion_joules(v_dd, f_main_hz)
    comps = {k: s * e_conv for k, s in ENERGY_SHARES.items()}
    if not relu_fused:
        # no early-stop credit: scale the ADC back up to full conversions
        avg_cycles = neg_fraction * 1.0 + (1.0 - neg_fraction) * SAR_CYCLES
        comps["adc"] = comps["adc"] * (SAR_CYCLES / avg_cycles)
    return float(n_conversions * sum(comps.values()))
