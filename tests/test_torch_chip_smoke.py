"""CPU rehearsal of ``chip_smoke.py``'s families phase: its runs at a
reduced size (2 layers, d_model 64, int8 configs; the state-space runs
with the reduced SSD chunk of 8) through the plain versions, with the
same prompts, geometry and gates as on the card.

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
    # continuous runs: 8 prefill-chunk passes and 72 decode steps; the
    # state-space runs: 6 calls (4 prompts, a batch of 4, a 4096-token
    # prompt) of a prefill and 32 decode steps.
    assert passes == {"moe-a": {"generate": 68}, "moe-b": {"generate": 68},
                      "swa": {"generate": 33},
                      "dense-g1": {"continuous": 80},
                      "dense-d160": {"continuous": 80, "generate": 17},
                      "ssm": {"generate": 198}, "hybrid": {"generate": 198}}
    assert all(line["ok"] for line in lines)
    assert set(launches.values()) == {0}
    for line in lines[-2:]:
        assert line["prefill_logit_noise_floor"] == [0.0] * 9
        assert line["prefill_logit_max_abs_diff"] == [0.0] * 9
        assert line["gated_prompt_lens"] == [64, 192, 512, 1024] + [512] * 4 \
            + [4096]
        assert line["first_tokens_identical"] == 9


def test_family_k1_counts_per_layer(smoke):
    """K1 launches of one block's pass at the published widths: q, k, v,
    o and the MLP's three, or three per expert (one per bank) and the
    shared experts' three."""
    counts = {arch: smoke.k1_per_layer(configs.get_config(arch))
              for _, arch, _, _ in smoke.FAMILY_RUNS}
    assert counts == {"moonshot-v1-16b-a3b": 199,
                      "granite-moe-1b-a400m": 100, "h2o-danube-3-4b": 7,
                      "deepseek-7b": 7, "stablelm-12b": 7,
                      "mamba2-1.3b": 2, "zamba2-2.7b": 2}
    # A whole pass: mamba2's 48 x 2 + the head; zamba2's 54 x 2, the
    # shared block's 7 in each of 9 groups, + the head.
    assert smoke.k1_per_pass(configs.get_config("mamba2-1.3b")) == 97
    assert smoke.k1_per_pass(configs.get_config("zamba2-2.7b")) == 172
    assert smoke.k1_per_pass(configs.get_config("deepseek-7b")) == 30 * 7 + 1
