"""CPU rehearsal of ``chip_smoke.py``'s families phase: its runs at a
reduced size (2 layers, d_model 64, int8 configs) through the plain
versions, with the same prompts, geometry and gates as on the card.

The phase's schedule does not depend on the model's numbers, so the
stack passes counted here are the card's: the K1 launch counts the card
must show are these passes times each model's per-layer count.  On the
CPU no kernel launches, so the launch gates are the card's alone."""
import dataclasses
import pathlib
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.paged_attention import ops as paged_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_families_phase_rehearsal(smoke):
    cfgs = {name: dataclasses.replace(configs.reduced_config(arch),
                                      kv_cache_dtype="int8")
            for name, arch, _, _ in smoke.FAMILY_RUNS}
    lines, launches, failures = smoke.families_path(
        torch, cim_ops, paged_ops, device="cpu", configs=cfgs)
    assert failures == []
    passes = {line["run"]: {tag: run["passes"]
                            for tag, run in line["runs"].items()}
              for line in lines}
    # A prefill and 16 (32 for the window) decode steps per prompt; the
    # continuous runs: 8 prefill-chunk passes and 72 decode steps.
    assert passes == {"moe-a": {"generate": 68}, "moe-b": {"generate": 68},
                      "swa": {"generate": 33},
                      "dense-g1": {"continuous": 80},
                      "dense-d160": {"continuous": 80, "generate": 17}}
    assert all(line["ok"] for line in lines)
    assert set(launches.values()) == {0}


def test_family_k1_counts_per_layer(smoke):
    """K1 launches of one block's pass at the published widths: q, k, v,
    o and the MLP's three, or three per expert (one per bank) and the
    shared experts' three."""
    counts = {arch: smoke.k1_per_layer(configs.get_config(arch))
              for _, arch, _, _ in smoke.FAMILY_RUNS}
    assert counts == {"moonshot-v1-16b-a3b": 199,
                      "granite-moe-1b-a400m": 100, "h2o-danube-3-4b": 7,
                      "deepseek-7b": 7, "stablelm-12b": 7}
