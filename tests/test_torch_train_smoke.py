"""CPU rehearsal of ``chip_smoke.py``'s train phase and of the durable
phase's exact-hit gate, through the plain versions at a reduced size
(granite-moe at 2 layers and d_model 64 under ``qat``; qwen3-8b at 2
layers with an int8 pool), with the same steps, prompts, geometry and
gates as on the card.

The serve step's schedule does not depend on the model's numbers, so
the stack passes counted here are the card's: K1 must launch those
passes times ``k1_per_pass`` of the published granite-moe there.  On
the CPU no kernel launches, so the launch gates are the card's alone."""
import dataclasses
import pathlib
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.paged_attention import ops as paged_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small CPU ops
    gain nothing from more, and the suite runs several files at once on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_train_config_is_the_published_granite(smoke):
    cfg = smoke.train_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == \
        (24, 1024, 16, 8)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) == \
        (32, 8, 512)
    assert (cfg.vocab, cfg.padded_vocab, cfg.tie_embeddings) == \
        (49155, 49408, False)
    assert (cfg.dtype, cfg.linear_mode) == ("bfloat16", "qat")
    assert 1.38e9 < cfg.param_count() < 1.39e9
    # The deploy step: 4 calls of a prefill and 16 decode steps, each
    # pass 24 x (4 + 3 x 32) + the head.
    assert smoke.k1_per_pass(cfg) == 2401


def test_train_phase_rehearsal(smoke):
    cfg = dataclasses.replace(configs.reduced_config(smoke.TRAIN_ARCH),
                              linear_mode="qat", kv_cache_dtype="int8")
    result, launches, failures = smoke.train_path(
        torch, cim_ops, paged_ops, device="cpu", cfg=cfg)
    assert failures == []
    assert result["ok"] and result["loss_fell"]
    assert len(result["losses"]) == smoke.TRAIN_STEPS
    deploy = result["deploy"]
    assert deploy["runs"]["generate"]["passes"] == 68 == \
        len(smoke.DEPLOY_PROMPTS) * (smoke.FAMILY_NEW["generate"] + 1)
    assert deploy["gated_prompt_lens"] == list(smoke.DEPLOY_PROMPTS)
    assert deploy["first_token_mismatches"] == []
    resume = result["resume"]
    assert resume["layers"] == smoke.RESUME_LAYERS
    assert all(resume["bit_identical"].values())
    assert resume["resumed_steps"] == [3, 4, 5]
    assert set(launches.values()) == {0}


def test_durable_exact_hit_gate_rehearsal(smoke):
    """The durable phase's exact-full-prompt hits (the two duplicated
    prompts) are judged on the chunked cached run by the logit gate: the
    hit's first-token logits against the uncached run's, within 1.5x the
    floor between the uncached run's chunks and a recompute of the last
    16-token block.  The hit computes exactly that recompute."""
    cfg = dataclasses.replace(configs.reduced_config("qwen3-8b"),
                              kv_cache_dtype="int8")
    result, _, failures = smoke.durable_path(torch, cfg, cim_ops, paged_ops,
                                             device="cpu")
    assert failures == []
    gate = result["gates"]["cached_chunked_exact_hits"]
    assert gate["rids"] == [106, 107] and gate["recomputed_tokens"] == [16,
                                                                         16]
    assert gate["prefill_logit_max_abs_diff"] == \
        gate["prefill_logit_noise_floor"]
    assert gate["exact_hit_first_token_floor"] > 0
    assert result["gates"]["cached_chunked"]["mismatches"] == []


@pytest.mark.parametrize("tail", [0, 16])
def test_chunked_prefill_logits_recompute(smoke, tail):
    """``recompute_tail`` adds the recomputed block's logits and leaves
    the full prefill's as they were."""
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.reduced_config("qwen3-8b"),
                              kv_cache_dtype="int8")
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (96,),
                           generator=torch.Generator().manual_seed(1))
    full = smoke.chunked_prefill_logits(torch, params, cfg, prompt, None,
                                        chunk=64, device="cpu")
    out = smoke.chunked_prefill_logits(torch, params, cfg, prompt, None,
                                       chunk=64, device="cpu",
                                       recompute_tail=tail)
    if tail:
        assert torch.equal(out[0], full) and out[1].shape == full.shape
    else:
        assert torch.equal(out, full)
