"""LM wrapper: embeddings -> stack -> final norm -> head (port of the dense,
paged-serving entry points of ``repro/models/model.py``).

  init(cfg, generator, device)                 -> params
  freeze_params(params, a_scale, plan)         -> deployed params
  forward(params, batch, cfg)                  -> (hidden, aux)
  logits_fn(params, h, cfg, mode)              -> logits (padded vocab masked)
  prefill_chunk(params, tokens, cfg, ...)      -> (last logits, pages)
  decode_step(params, batch, caches, cfg)      -> (logits, caches)
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.core import backend as backend_lib
from repro_torch.models import layers, transformer


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random master parameters drawn from ``generator`` (on its own
    device), placed on ``device``."""
    dev = device_lib.resolve(device)
    dt = _dtype(cfg)
    p = {
        "embed": layers.init_embedding(generator, cfg.padded_vocab,
                                       cfg.d_model, dt, device=dev),
        "stack": transformer.init_stack(generator, cfg, dt, device=dev),
        "final_norm": layers.init_rmsnorm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.init_lm_head(generator, cfg.d_model,
                                           cfg.padded_vocab, dt, device=dev)
    return p


# Routing quality is precision-sensitive: the default deployment keeps any
# router in float while every other weight-stationary linear goes int8.
DEFAULT_DEPLOY_PLAN = backend_lib.DeploymentPlan(
    rules=(("*router*", backend_lib.LayerRule("exact")),),
    default="w8a8",
)


def _as_deploy_plan(plan) -> backend_lib.DeploymentPlan:
    if plan is None:
        return DEFAULT_DEPLOY_PLAN
    return backend_lib.as_plan(plan, default="w8a8")


def freeze_params(params, a_scale: float = 1.0, plan=None):
    """Deploy transform: every weight-stationary linear is frozen by its
    plan-resolved backend (int8 with static per-channel scales for
    deployed backends, untouched master params for float ones).  Layer
    paths are the JAX package's ('stack/blocks/attn/q', 'lm_head', ...):
    the per-layer list adds no path component, so one plan resolves the
    same way in both packages."""
    plan = _as_deploy_plan(plan)

    def freeze_with(rule, node):
        backend = backend_lib.get_backend(rule.backend)
        w = node["w"]
        spec = backend_lib.LinearSpec(
            in_dim=int(w.shape[-2]), out_dim=int(w.shape[-1]),
            use_bias="b" in node, mode=rule.backend)
        a_s = a_scale if rule.a_scale is None else rule.a_scale
        return backend.freeze(node, spec, a_s)

    def walk(path, node):
        if isinstance(node, list):
            return [walk(path, v) for v in node]
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor):
                return freeze_with(plan.rule_for(path), node)
            return {k: walk(f"{path}/{k}" if path else k, v)
                    for k, v in node.items()}
        return node

    return walk("", params)


def forward(params, batch, cfg, *, mode=None):
    """Full-sequence forward to final hidden states.  Returns (h, aux)."""
    x = layers.embed(params["embed"], batch["tokens"])
    h, aux = transformer.apply_stack(params["stack"], x, cfg, mode=mode)
    return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps), aux


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return {"w": params["embed"]["table"].T}
    return params["lm_head"]


def logits_fn(params, h, cfg, mode=None):
    logits = layers.dense(_head_weight(params, cfg), h, mode or "exact",
                          dtype=torch.float32, path="lm_head")
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


def prefill_chunk(params, tokens, cfg, *, pages, block_tables, pos, n_tok,
                  write_mask=None, has_past: bool = True, mode=None):
    """One causal chunk of paged prefill: advance each row's prompt by up
    to ``tokens.shape[1]`` positions, writing the chunk's K/V straight into
    the pool pages (in place).

    ``tokens`` [B, C] (right-padded ragged tails); ``pos`` [B] page-aligned
    chunk starts; ``n_tok`` [B] valid tokens; ``write_mask`` [B] bool marks
    rows actually prefilling.  Returns ``(logits [B, V] at each row's last
    valid position, pages)``."""
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    n_tok = torch.as_tensor(n_tok, dtype=torch.int32, device=dev)
    caches = {"kv": pages, "block_tables": block_tables,
              "lens": torch.as_tensor(pos, dtype=torch.int32, device=dev),
              "chunk_len": n_tok, "pf_has_past": bool(has_past)}
    if write_mask is not None:
        caches["write_mask"] = torch.as_tensor(write_mask, device=dev).bool()
    h, caches = transformer.decode_stack(params["stack"], x, cfg, caches,
                                         mode=mode)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    idx = torch.clamp(n_tok.long() - 1, 0, tokens.shape[1] - 1)
    h_last = torch.gather(h, 1, idx[:, None, None].expand(-1, 1,
                                                          h.shape[-1]))
    logits = logits_fn(params, h_last, cfg, mode)
    return logits[:, 0], caches["kv"]


def decode_step(params, batch, caches, cfg, *, mode=None):
    """One token for every row.  Returns (logits [B, 1, V], caches)."""
    x = layers.embed(params["embed"], batch["tokens"])
    h, caches = transformer.decode_stack(params["stack"], x, cfg, caches,
                                         mode=mode)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return logits_fn(params, h, cfg, mode), caches
