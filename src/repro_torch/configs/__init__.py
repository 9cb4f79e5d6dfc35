"""Config registry for the PyTorch port: ``get_config`` and the reduced
smoke variants.  Only the dense main-path architecture is registered so
far; the other families arrive with their model slices.  The paper's
VGG-8 deployment lives beside them, as in the JAX package:
``repro_torch.configs.vgg8_cifar10.config()``."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,  # noqa: F401
                                      ShapeConfig, SSMConfig, TrainConfig)

ARCH_IDS = (
    "qwen3-8b",
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
