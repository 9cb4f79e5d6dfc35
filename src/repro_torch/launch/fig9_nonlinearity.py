"""Fig. 9: non-linearity of the sensitive analog modules (the port of the
JAX package's ``benchmarks/fig9_nonlinearity.py``).

Usage: python -m repro_torch.launch.fig9_nonlinearity [--device cpu] \\
    [--chips 200] [--adcs 50]

(a) CAAT INL histogram over fabricated-chip samples: ~70% of chips reach
    >= 7b summation accuracy (paper, post-layout).
(b) ADC INL: max |INL| = 1.2 LSB (paper, measured).

The chips are the ones the JAX package samples: CAAT ``i`` at
``PRNGKey(i)``, ADC ``i`` at ``PRNGKey(1000 + i)``, drawn here as one
batch of keys each.  Every value is the behavioural model's
(``core/caat.py``, ``core/adc.py``), not a measurement.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import adc as adc_lib
from repro_torch.core import caat, macro
from repro_torch.launch.common import emit, parser, resolve

HIST_BINS = [0, 5, 6, 6.5, 7, 7.5, 8, 9]


def keys(seeds, device) -> torch.Tensor:
    """``PRNGKey(s)`` for each seed, stacked: ``[n, 2]``."""
    return torch.stack([prng.PRNGKey(s, device=device) for s in seeds])


def measure(device, chips: int, adcs: int) -> tuple[np.ndarray, np.ndarray]:
    """CAAT effective bits of chips ``0 .. chips - 1`` and the max |INL|
    of ADCs ``1000 .. 1000 + adcs - 1`` (float64 arrays)."""
    cfg = macro.nominal_config()
    batch = caat.sample_caat(keys(range(chips), device), cfg.caat)
    bits = np.array([
        caat.caat_effective_bits({k: v[i] for k, v in batch.items()},
                                 cfg.caat)
        for i in range(chips)])
    luts = adc_lib.sample_adc(keys(range(1000, 1000 + adcs), device),
                              cfg.adc)["inl_lut"]
    return bits, luts.abs().amax(-1).cpu().numpy().astype(np.float64)


def main(device="cuda", *, chips: int = 200, adcs: int = 50) -> dict:
    """Print JAX's rows, assert its claims and return the values."""
    bits, inls = measure(resolve(device), chips, adcs)
    frac7 = float(np.mean(bits >= 7.0))
    rows = [emit("fig9a_caat_accuracy", 0.0,
                 f">=7b fraction={frac7:.2f} (paper ~0.70) "
                 f"median={np.median(bits):.2f}b "
                 f"pass={0.55 <= frac7 <= 0.85}")]
    hist, edges = np.histogram(bits, bins=HIST_BINS)
    rows.append(emit("fig9a_histogram", 0.0,
                     " ".join(f"[{edges[i]:.1f},{edges[i+1]:.1f}):{hist[i]}"
                              for i in range(len(hist)))))
    assert 0.55 <= frac7 <= 0.85

    rows.append(emit("fig9b_adc_max_inl", 0.0,
                     f"max|INL|={max(inls):.2f} LSB (paper 1.2) "
                     f"pass={abs(max(inls)-1.2)<0.05}"))
    assert abs(max(inls) - 1.2) < 0.05
    return {"bits": bits.tolist(), "frac_7b": frac7,
            "median_bits": float(np.median(bits)),
            "histogram": hist.tolist(), "adc_max_inl": inls.tolist(),
            "rows": rows}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--chips", type=int, default=200)
    ap.add_argument("--adcs", type=int, default=50)
    args = ap.parse_args()
    main(args.device, chips=args.chips, adcs=args.adcs)
