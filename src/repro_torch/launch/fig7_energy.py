"""Fig. 7(b): energy comparison vs the parallel-activation-input baseline
(the port of the JAX package's ``benchmarks/fig7_energy.py``).

Usage: python -m repro_torch.launch.fig7_energy [--device cpu]

Paper claims: ADC energy ~1/8 of the baseline (one conversion per 8b MAC
instead of one per activation bit); a further ~2x from ReLU early-stop;
1.6x macro-level energy efficiency including peripherals.  The measured
part runs random +/- data through the macro simulation on the chip that
the JAX package samples at ``PRNGKey(0)``, with its activations and
weights at ``PRNGKey(1)`` and ``PRNGKey(2)``.  The energies are the
macro's model (``core/energy.py``), not measurements.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import adc as adc_lib
from repro_torch.core import energy, macro
from repro_torch.launch.common import emit, parser, resolve


def main(device="cuda") -> dict:
    """Print JAX's rows, assert its claims and return the values."""
    dev = resolve(device)
    rep = energy.breakdown(neg_fraction=0.55)
    rows = [
        emit("fig7b_adc_ratio", 0.0,
             f"{rep.adc_ratio:.2f}x (paper ~8x) "
             f"pass={7.0 <= rep.adc_ratio <= 9.0}"),
        emit("fig7b_relu_early_stop", 0.0,
             f"{rep.relu_early_stop_factor:.2f}x (paper ~2x) "
             f"pass={1.7 <= rep.relu_early_stop_factor <= 2.3}"),
        emit("fig7b_macro_efficiency", 0.0,
             f"{rep.macro_efficiency_ratio:.2f}x (paper 1.6x) "
             f"pass={1.4 <= rep.macro_efficiency_ratio <= 1.8}")]
    assert 7.0 <= rep.adc_ratio <= 9.0
    assert 1.7 <= rep.relu_early_stop_factor <= 2.3
    assert 1.4 <= rep.macro_efficiency_ratio <= 1.8

    # Measure the actual negative fraction on random +/- data (as in the
    # paper's random-input measurement) and report the induced saving.
    cfg = macro.nominal_config(rows=256)
    chip = macro.sample_chip(prng.PRNGKey(0, device=dev), cfg)
    a = prng.randint(prng.PRNGKey(1, device=dev), (64, 256), -128,
                     128).to(torch.int8)
    w = prng.randint(prng.PRNGKey(2, device=dev), (256, 64), -128,
                     128).to(torch.int8)
    _, stats = macro.cim_matmul_sim(a, w, chip, 256 * 128 * 128 * 0.25,
                                    cfg, relu=True)
    neg = float(stats["neg_fraction"])
    cycles = float(adc_lib.average_conversion_cycles(torch.tensor(neg),
                                                     cfg.adc))
    rows.append(emit("fig7b_measured_neg_fraction", 0.0,
                     f"neg={neg:.3f} avg_sar_cycles={cycles:.2f} "
                     f"saving={cfg.adc.sar_cycles/cycles:.2f}x"))
    return {"adc_ratio": rep.adc_ratio,
            "relu_early_stop": rep.relu_early_stop_factor,
            "macro_efficiency": rep.macro_efficiency_ratio,
            "neg_fraction": neg, "avg_sar_cycles": cycles,
            "sar_saving": cfg.adc.sar_cycles / cycles, "rows": rows}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
