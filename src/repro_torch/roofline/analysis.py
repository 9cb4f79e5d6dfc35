"""Roofline terms of one dry-run cell (port of
``repro/roofline/analysis.py``; the formulas are JAX's):

  compute_term    = flops_per_device / peak_FLOP/s
  memory_term     = traffic_bytes_per_device / HBM_bw
  collective_term = collective_wire_bytes / (chips * link_bw)

JAX reads its collectives from the optimized HLO text; the port's come
from the counter of the traced step (``op_count``), one record per
collective op, folded here by :func:`collective_bytes_from_records` into
the same ``{kind: {count, payload_bytes, wire_bytes}}`` dict with the
same ring factors of the group size g:

  all-reduce          2 (g-1)/g      (ring: reduce-scatter + all-gather)
  all-gather          (g-1)/g        (per-device output bytes crossing links)
  reduce-scatter      (g-1)/g        (input bytes leaving, 1/g staying)
  all-to-all          (g-1)/g
  collective-permute  1.0            (send and recv: the payload crosses
                                      one link)
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def ring_factor(kind: str, g: int) -> float:
    """Wire bytes per payload byte of one ``kind`` collective over ``g``
    ranks."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return (g - 1) / g


def empty_collectives() -> dict:
    return {k: {"count": 0, "payload_bytes": 0.0, "wire_bytes": 0.0}
            for k in COLL_KINDS}


def collective_bytes_from_records(records) -> dict:
    """Per-kind ``{'count', 'payload_bytes', 'wire_bytes'}`` of
    ``(kind, per_shard_bytes, g)`` records, as JAX's
    ``collective_bytes_from_hlo`` folds its HLO ops: payload = the
    per-shard output bytes x g (the whole group's data), wire = payload x
    the ring factor."""
    out = empty_collectives()
    for kind, per_shard, g in records:
        g = max(int(g), 1)
        out[kind]["count"] += 1
        out[kind]["payload_bytes"] += float(per_shard * g)
        out[kind]["wire_bytes"] += float(per_shard * g
                                         * ring_factor(kind, g))
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(result: dict, *, model_flops: float,
                   int8: bool = False) -> RooflineTerms:
    """result: one dry-run cell dict (launch/dryrun.py).

    flops/traffic are PER-DEVICE (rank 0's traced step); collective wire
    bytes are whole-group totals, so the collective term divides by the
    aggregate link bandwidth."""
    chips = result["n_chips"]
    peak = hw.PEAK_FLOPS_INT8 if int8 else hw.PEAK_FLOPS_BF16
    flops_dev = float(result["flops_per_device"])
    traffic_dev = float(result["traffic_bytes_per_device"])
    wire = sum(c["wire_bytes"] for c in result["collectives"].values())
    compute_s = flops_dev / peak
    memory_s = traffic_dev / hw.HBM_BW
    collective_s = wire / (chips * hw.ICI_BW_PER_LINK)
    flops = flops_dev * chips  # global, for the useful-ratio metric
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, hlo_flops=flops,
        useful_ratio=model_flops / flops if flops else 0.0,
    )


def model_flops_for_cell(cfg, shape) -> float:
    """6*N*D (train), 2*N*D (prefill), 2*N*B (decode); N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch
