"""Dense decoder blocks and the layer stack (port of the dense family of
``repro/models/transformer.py``).

The JAX package stacks layers on a leading ``[L, ...]`` axis for
``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts and
the stack is a Python loop.  The paged KV pool keeps its leading layer
axis (``[L, NB, BS, KVH, D]``), and each layer works on its ``[l]`` view,
so in-place page writes land in the shared pool.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers


def init_dense_block(generator, cfg, dtype, *, device="cpu") -> dict:
    return {
        "attn_norm": layers.init_rmsnorm(cfg.d_model, device=device),
        "attn": attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dtype, device=device),
        "mlp_norm": layers.init_rmsnorm(cfg.d_model, device=device),
        "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                               dtype, device=device),
    }


def dense_block(p, x, cfg, *, cache=None, mode=None):
    h, new_cache = attn_lib.attention(
        p["attn"], layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        kv_cache=cache, mode=mode)
    x = x + h
    x = x + layers.mlp(p["mlp"],
                       layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps),
                       cfg.act, mode or cfg.linear_mode)
    return x, new_cache


def _check_dense(cfg):
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: only the dense family is ported")


def init_stack(generator, cfg, dtype=torch.bfloat16, *, device="cpu"
               ) -> dict:
    _check_dense(cfg)
    return {"blocks": [init_dense_block(generator, cfg, dtype, device=device)
                       for _ in range(cfg.n_layers)]}


def apply_stack(params, x, cfg, *, mode=None):
    """Full-sequence forward (no caches).  Returns (hidden, aux_loss=0)."""
    _check_dense(cfg)
    for blk in params["blocks"]:
        x, _ = dense_block(blk, x, cfg, mode=mode)
    return x, 0.0


def _layer(pages, i):
    """Layer ``i``'s view of a stacked pool leaf (tensor or QTensor)."""
    if isinstance(pages, quant.QTensor):
        return quant.QTensor(pages.q[i], pages.scale[i])
    return pages[i]


def decode_stack(params, x, cfg, caches: dict, *, mode=None):
    """Decode (S == 1) or prefill-chunk (S > 1) pass through the stack over
    a paged pool.  ``caches["kv"]`` holds the pool ``{k, v}`` with leading
    layer axis; block tables / lengths / write mask / chunk lengths are
    layer-invariant.  Pages are updated in place; returns (hidden,
    caches)."""
    _check_dense(cfg)
    if "block_tables" not in caches:
        raise NotImplementedError(
            "dense (non-paged) KV caches are not ported yet")
    shared = {key: caches[key]
              for key in ("block_tables", "lens", "write_mask", "chunk_len",
                          "pf_has_past")
              if key in caches}
    pages = caches["kv"]
    for i, blk in enumerate(params["blocks"]):
        kv = dict(k=_layer(pages["k"], i), v=_layer(pages["v"], i), **shared)
        x, _ = dense_block(blk, x, cfg, cache=kv, mode=mode)
    return x, caches
