"""Fig. 8: energy / area / latency breakdowns of the macro (the port of
the JAX package's ``benchmarks/fig8_breakdown.py``).

Usage: python -m repro_torch.launch.fig8_breakdown [--device cpu]

Paper claims: the ADC is only 3% of area and 8% of energy; 51.2 GOPS at
1 GHz.  The values are the macro's energy model (``core/energy.py``),
not measurements.
"""
from __future__ import annotations

from repro_torch.core import energy
from repro_torch.launch.common import emit, parser, resolve


def main(device="cuda") -> dict:
    """Print JAX's rows, assert its claims and return the values."""
    resolve(device)
    rep = energy.breakdown(v_dd=1.0, f_main_hz=1e9)
    total = rep.total_per_conversion_j
    rows = [emit(f"fig8_energy_{k}", 0.0,
                 f"{v*1e12:.1f}pJ share={v/total:.2%}")
            for k, v in rep.components_j.items()]
    adc_share = rep.components_j["adc"] / total
    rows.append(emit("fig8_adc_energy_share", 0.0,
                     f"{adc_share:.1%} (paper 8%) "
                     f"pass={abs(adc_share-0.08)<0.01}"))
    assert abs(adc_share - 0.08) < 0.01

    area = energy.area_breakdown_mm2(1.0)
    rows.append(emit("fig8_adc_area_share", 0.0,
                     f"{area['adc']:.1%} (paper 3%) "
                     f"pass={abs(area['adc']-0.03)<0.005}"))
    assert abs(area["adc"] - 0.03) < 0.005

    lat = energy.latency_breakdown_ns(1e9)
    tot_ns = sum(lat.values())
    rows += [emit(f"fig8_latency_{k}", 0.0, f"{v:.1f}ns share={v/tot_ns:.1%}")
             for k, v in lat.items()]
    gops = energy.throughput_ops(1e9) / 1e9
    rows.append(emit("fig8_throughput_1GHz", 0.0,
                     f"{gops:.1f} GOPS (paper 51.2) "
                     f"pass={abs(gops-51.2)<0.5}"))
    assert abs(gops - 51.2) < 0.5
    return {"adc_energy_share": adc_share, "adc_area_share": area["adc"],
            "gops_1ghz": gops, "rows": rows}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
