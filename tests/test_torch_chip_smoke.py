"""CPU rehearsal of ``chip_smoke.py``'s families phase: its runs at a
reduced size (2 layers, d_model 64, int8 configs; the state-space runs
with the reduced SSD chunk of 8; whisper with 2 encoder layers) through
the plain versions, with the same prompts, geometry and gates as on the
card.

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
    # prompt) of a prefill and 32 decode steps; whisper: 4 calls (4 and
    # 64 decoder tokens at batch 1 and 4) of a prefill and 32 decode
    # steps, each prefill one encoder pass and one cross K/V projection;
    # qwen2-vl: 3 calls of a prefill and 16 decode steps.
    assert passes == {"moe-a": {"generate": 68}, "moe-b": {"generate": 68},
                      "swa": {"generate": 33},
                      "dense-g1": {"continuous": 80},
                      "dense-d160": {"continuous": 80, "generate": 17},
                      "ssm": {"generate": 198}, "hybrid": {"generate": 198},
                      "encdec": {"generate": 132}, "mrope": {"generate": 51}}
    assert all(line["ok"] for line in lines)
    assert set(launches.values()) == {0}
    by_run = {line["run"]: line for line in lines}
    gen = by_run["encdec"]["runs"]["generate"]
    assert (gen["encoder_passes"], gen["cross_kv_passes"]) == (4, 4)
    assert by_run["encdec"]["gated_prompt_lens"] == [4, 64] + [4] * 4 \
        + [64] * 4
    assert by_run["mrope"]["gated_prompt_lens"] == [64, 288, 2560]
    for run, rows in (("ssm", 9), ("hybrid", 9), ("encdec", 10),
                      ("mrope", 3)):
        assert by_run[run]["prefill_logit_noise_floor"] == [0.0] * rows
        assert by_run[run]["prefill_logit_max_abs_diff"] == [0.0] * rows
    for run in ("encdec", "mrope"):
        assert by_run[run]["liveness"]["first_token_logit_max_abs_diff"] > 0
    for line in (by_run["ssm"], by_run["hybrid"]):
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
                      "mamba2-1.3b": 2, "zamba2-2.7b": 2,
                      "whisper-large-v3": 8, "qwen2-vl-72b": 7}
    # A whole pass: mamba2's 48 x 2 + the head; zamba2's 54 x 2, the
    # shared block's 7 in each of 9 groups, + the head.
    assert smoke.k1_per_pass(configs.get_config("mamba2-1.3b")) == 97
    assert smoke.k1_per_pass(configs.get_config("zamba2-2.7b")) == 172
    assert smoke.k1_per_pass(configs.get_config("deepseek-7b")) == 30 * 7 + 1
    # whisper: a decoder pass 32 x 8 + the head; its prefill adds an
    # encoder pass (32 x 6) and the cross K/V (32 x 2).  qwen2-vl: 80 x 7
    # + the head.
    whisper = configs.get_config("whisper-large-v3")
    assert smoke.k1_per_pass(whisper) == 257
    assert smoke.k1_encoder(whisper) == (192, 64)
    assert smoke.k1_per_pass(configs.get_config("qwen2-vl-72b")) == 561
    assert smoke.k1_encoder(configs.get_config("qwen2-vl-72b")) == (0, 0)


@pytest.mark.parametrize("free_gb,layers", [(85.0, 80), (60.0, 58)])
def test_fit_depth_cuts_only_what_memory_forces(smoke, free_gb, layers):
    """qwen2-vl-72b's blocks hold 877,658,112 int8 weights each (q/o 2 x
    8192^2, k/v 2 x 8192 x 1024, the MLP 3 x 8192 x 29568); beside the
    bf16 embedding, the int8 head and the headroom, all 80 fit in 85 GB
    of free memory, and 60 GB takes the depth to 58."""
    import types
    cfg = configs.get_config("qwen2-vl-72b")
    assert smoke.block_bytes(cfg) == 877_658_112
    card = types.SimpleNamespace(cuda=types.SimpleNamespace(
        mem_get_info=lambda: (free_gb * 1e9, 85e9)))
    cut, reading = smoke.fit_depth(card, cfg, "cuda")
    assert cut.n_layers == layers
    assert reading["free_gb"] == free_gb
    assert smoke.fit_depth(card, cfg, "cpu") == (cfg, None)
