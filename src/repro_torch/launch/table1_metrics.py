"""Table I: throughput and energy-efficiency operating points (the port
of the JAX package's ``benchmarks/table1_metrics.py``).

Usage: python -m repro_torch.launch.table1_metrics [--device cpu]

Paper: 51.2 GOPS @1.0V/1GHz (3.53 TOPS/W); 35.8 GOPS @0.8V/700MHz
(10.1 TOPS/W); 10.3 TOPS/W best efficiency @240 MHz.  The values are the
macro's operating-point model (``core/energy.py``), not measurements.
"""
from __future__ import annotations

from repro_torch.core import energy
from repro_torch.launch.common import emit, parser, resolve

POINTS = (
    ("1.0V_1GHz", 1.0, 1.0e9, 51.2, 3.53),
    ("0.8V_700MHz", 0.8, 0.7e9, 35.8, 10.1),
    ("0.76V_240MHz", 0.76, 0.24e9, None, 10.3),
)


def main(device="cuda") -> dict:
    """Print JAX's rows, assert its claims and return the values."""
    resolve(device)
    rows, points = [], {}
    for name, v, f, gops_paper, tw_paper in POINTS:
        gops = energy.throughput_ops(f) / 1e9
        tw = energy.tops_per_watt(v, f)
        ok = (gops_paper is None or abs(gops - gops_paper) / gops_paper < 0.02)
        ok = ok and abs(tw - tw_paper) / tw_paper < 0.05
        derived = f"GOPS={gops:.1f}"
        if gops_paper:
            derived += f" (paper {gops_paper})"
        derived += f" TOPS/W={tw:.2f} (paper {tw_paper}) pass={ok}"
        rows.append(emit(f"table1_{name}", 0.0, derived))
        assert ok, derived
        points[name] = {"gops": gops, "tops_per_w": tw}
    # Full supply sweep (the macro's 0.76-1.2 V range)
    for v in (0.76, 0.8, 0.9, 1.0, 1.1, 1.2):
        f = 1e9 * v  # assume fmax tracks supply linearly
        rows.append(emit(f"table1_sweep_{v:.2f}V", 0.0,
                         f"GOPS={energy.throughput_ops(f)/1e9:.1f} "
                         f"TOPS/W={energy.tops_per_watt(v, f):.2f}"))
    return {"points": points, "rows": rows}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
