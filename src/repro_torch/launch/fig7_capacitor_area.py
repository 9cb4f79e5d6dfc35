"""Fig. 7(a): capacitor network total capacitance vs quantization bit
width (the port of the JAX package's ``benchmarks/fig7_capacitor_area.py``).

Usage: python -m repro_torch.launch.fig7_capacitor_area [--device cpu]

Paper claims: for one 8b CAAT-L the hybrid binary-C-2C network needs 96C
vs 1032C fully-binary (10.8x).  The binary curve grows exponentially with
bit width; the hybrid curve grows linearly.  The values are the area
model's (``core/caat.py``), not measurements.
"""
from __future__ import annotations

from repro_torch.core import caat, energy
from repro_torch.launch.common import emit, parser, resolve


def main(device="cuda") -> dict:
    """Print JAX's rows, assert its claim and return the values."""
    resolve(device)
    curve = energy.capacitor_area_curve(bit_widths=(4, 5, 6, 7, 8, 9, 10))
    rows = []
    for bits, b_c, h_c in zip(curve["bits"], curve["binary_C"],
                              curve["hybrid_C"]):
        rows.append(emit(f"fig7a_capacitance_{bits}b", 0.0,
                         f"binary={b_c:.0f}C hybrid={h_c:.0f}C "
                         f"ratio={b_c/h_c:.1f}x"))
    b8 = caat.capacitor_total_binary(8)
    h8 = caat.capacitor_total_hybrid(8)
    ratio = b8 / h8
    ok = abs(h8 - 96) < 1.5 and 10.0 <= ratio <= 11.5
    rows.append(emit("fig7a_8b_claim", 0.0,
                     f"hybrid={h8:.0f}C (paper 96C) ratio={ratio:.1f}x "
                     f"(paper 10.8x) pass={ok}"))
    assert ok
    return {"curve": curve, "hybrid_8b_C": h8, "binary_8b_C": b8,
            "ratio_8b": ratio, "rows": rows}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
