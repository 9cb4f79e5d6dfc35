"""Config registry for the PyTorch port: ``get_config`` and the reduced
smoke variants, every arch of the JAX package in its order: the
decoder-only dense and MoE families, the encoder-decoder (whisper), M-RoPE
(qwen2-vl) and the state-space families (mamba2's SSM stack, zamba2's
hybrid).  The paper's VGG-8 deployment lives beside them, as in the JAX
package: ``repro_torch.configs.vgg8_cifar10.config()``."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,  # noqa: F401
                                      ShapeConfig, SSMConfig, TrainConfig)

ARCH_IDS = (
    "moonshot-v1-16b-a3b",
    "granite-moe-1b-a400m",
    "stablelm-12b",
    "qwen3-8b",
    "h2o-danube-3-4b",
    "deepseek-7b",
    "whisper-large-v3",
    "qwen2-vl-72b",
    "mamba2-1.3b",
    "zamba2-2.7b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.config()
    assert cfg.name == arch_id
    return cfg


def reduced_config(arch_id: str, *, n_layers: int = 2, d_model: int = 64,
                   vocab: int = 256) -> ModelConfig:
    """Small same-family config for CPU smoke tests (identical to the JAX
    package's reduced variant, so both packages build the same shapes)."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=(4 if cfg.n_kv_heads == cfg.n_heads else 2),
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab=vocab,
        head_dim=16,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=min(cfg.moe.top_k, 4), d_ff_expert=32,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, conv_k=cfg.ssm.conv_k, expand=2,
                              headdim=16, chunk=8)
    if cfg.hybrid_attn_interval:
        kw["hybrid_attn_interval"] = 2
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = n_layers
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 8
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 2, 2)   # head_dim/2 = 8 in reduced form
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Dry-run inputs (empty tensors: made under the caller's FakeTensorMode
# they allocate nothing)
# ---------------------------------------------------------------------------

def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason).  long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch at 524288 context "
                       "(quadratic prefill / unbounded KV) — see DESIGN.md §5")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                device="cpu") -> dict:
    """The global batch of a train/prefill step as empty tensors (the
    JAX package's ShapeDtypeStruct batch: int32 tokens and labels, bf16
    embeddings and frames, M-RoPE's [3, B, S] positions)."""
    import torch
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    batch: dict = {}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = torch.empty((b, s, cfg.d_model), dtype=bf16,
                                      device=device)
        batch["positions"] = torch.empty((3, b, s), dtype=i32, device=device)
    else:
        batch["tokens"] = torch.empty((b, s), dtype=i32, device=device)
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.empty((b, s, cfg.d_model), dtype=bf16,
                                      device=device)
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=i32, device=device)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                       batch: int | None = None, device="cpu") -> dict:
    """``{"batch", "caches"}`` of one decode step at a KV length of
    ``shape.seq_len``: int32 tokens [B, 1] (and positions [3, B, 1]) and
    ``transformer.init_caches``' bf16 caches (whisper's cross K/V over
    ``seq_len`` frames).  ``batch`` rows instead of the shape's global
    batch lay the caches out as the port's mesh serve does: each rank
    holds its rows' whole caches."""
    import torch

    from repro_torch.models import transformer
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    out: dict = {"tokens": torch.empty((b, 1), dtype=i32, device=device)}
    if cfg.frontend == "vision_stub":
        out["positions"] = torch.empty((3, b, 1), dtype=i32, device=device)
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = torch.empty((b, s, cfg.d_model), dtype=bf16, device=device)
    caches = transformer.init_caches(cfg, b, s, bf16, device=device,
                                     enc_out=enc_out)
    return {"batch": out, "caches": caches}
