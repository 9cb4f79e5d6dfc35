"""Roofline report generator: results/dryrun/*.json -> markdown tables
(port of ``repro/roofline/report.py``, reading the port's configs and the
card's constants).

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun]

``--detail`` renders the port's table instead, both quants side by side
(:func:`render_detail`), with the argument GiB of the JAX package's
layout (``port.jax_layout_argument_bytes``) beside the port's.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs as cfg_lib
from repro_torch.configs.base import SHAPES
from repro_torch.roofline import analysis, hw


def load_cells(directory: str) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        # older skip records carry identity only in the filename
        parts = os.path.basename(path)[:-5].split("__")
        if len(parts) == 4:
            c.setdefault("arch", parts[0])
            c.setdefault("shape", parts[1])
            c.setdefault("mesh", parts[2])
            c.setdefault("quant", parts[3])
        cells.append(c)
    return cells


def cell_row(c: dict) -> dict | None:
    if c.get("status") != "ok":
        return None
    cfg = cfg_lib.get_config(c["arch"])
    shape = SHAPES[c["shape"]]
    mf = analysis.model_flops_for_cell(cfg, shape)
    terms = analysis.roofline_terms(c, model_flops=mf,
                                    int8=(c.get("quant") == "w8a8"))
    wall = max(terms.compute_s, terms.memory_s, terms.collective_s)
    hbm_gib = (c["memory"]["temp_bytes"] + c["memory"]["argument_bytes"]) / 2**30
    return {
        "arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
        "quant": c.get("quant", "none"),
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "useful_ratio": terms.useful_ratio,
        "roofline_fraction": terms.compute_s / wall if wall else 0.0,
        "hbm_gib": hbm_gib,
        "fits": hbm_gib <= hw.HBM_PER_CHIP / 2**30,
        "compile_s": c.get("compile_s", 0.0),
    }


def render(cells: list[dict], mesh: str = "single",
           quant: str = "none") -> str:
    rows = [r for r in (cell_row(c) for c in cells)
            if r and r["mesh"] == mesh and r["quant"] == quant]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL/HLO | roofline frac | GiB/chip | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['hbm_gib']:.1f} | "
            f"{'Y' if r['fits'] else 'N'} |")
    skips = [c for c in cells
             if c.get("status") == "skipped" and c["mesh"] == mesh]
    for c in skips:
        out.append(f"| {c['arch']} | {c['shape']} | — | — | — | skipped | — |"
                   f" — | — | — |")
    return "\n".join(out)


def render_detail(cells: list[dict], mesh: str = "single") -> str:
    """One row per (arch, shape) of ``mesh`` with an ok cell, each figure
    as ``none / w8a8`` where they differ ("—" for a quant not traced):
    per-device flops, traffic and collective wire bytes, argument and
    temp GiB, the JAX layout's argument GiB, the dominant term, whether
    arguments + temp fit the card, and the trace's seconds."""
    gib = 2**30
    by: dict = {}
    for c in cells:
        if c.get("status") == "ok" and c["mesh"] == mesh:
            by.setdefault((c["arch"], c["shape"]), {})[
                c.get("quant", "none")] = c

    def pair(fn, cs):
        vals = [("—" if c is None else fn(c)) for c in cs]
        return vals[0] if vals[0] == vals[1] else " / ".join(vals)

    out = ["| arch | shape | flops/dev | traffic B/dev | coll wire B | "
           "arg GiB | JAX-layout arg GiB | temp GiB | dominant | fits | "
           "trace s |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), q in sorted(by.items()):
        cs = [q.get("none"), q.get("w8a8")]
        out.append("| " + " | ".join([
            arch, shape,
            pair(lambda c: f"{c['flops_per_device']:.3e}", cs),
            pair(lambda c: f"{c['traffic_bytes_per_device']:.3e}", cs),
            pair(lambda c: f"{sum(v['wire_bytes'] for v in c['collectives'].values()):.3e}", cs),
            pair(lambda c: f"{c['memory']['argument_bytes'] / gib:.2f}", cs),
            pair(lambda c: f"{c['port']['jax_layout_argument_bytes'] / gib:.2f}", cs),
            pair(lambda c: f"{c['memory']['temp_bytes'] / gib:.2f}", cs),
            pair(lambda c: cell_row(c)["dominant"], cs),
            pair(lambda c: "Y" if cell_row(c)["fits"] else "N", cs),
            pair(lambda c: f"{c.get('compile_s', 0.0):.0f}", cs)]) + " |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--detail", action="store_true",
                    help="the port's per-cell table (both quants)")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    if args.detail:
        print(render_detail(cells, args.mesh))
        return
    print(render(cells, args.mesh, args.quant))


if __name__ == "__main__":
    main()
