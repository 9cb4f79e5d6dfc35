"""Blocks and the layer stack (port of ``repro/models/transformer.py``).

  dense   pre-norm attn + MLP residual blocks
  moe     pre-norm attn + MoE FFN
  ssm     Mamba-2 residual blocks (mamba2-1.3b)
  hybrid  Mamba-2 backbone + one weight-SHARED attention block applied at
          the start of every group of ``hybrid_attn_interval`` layers
          (zamba2: shared weights, a KV cache per group)
  encdec  bidirectional encoder + causal decoder with cross-attention
          (whisper: ``{"encoder": [...], "decoder": [...]}``)

The JAX package stacks layers on a leading ``[L, ...]`` axis for
``lax.scan``; here ``params["blocks"]`` (``encoder`` / ``decoder``) is a
list of per-layer dicts and the stack is a Python loop.  The paged KV pool
keeps its leading layer axis (``[L, NB, BS, KVH, D]``), as do the dense
caches of ``Engine.generate``, the cross K/V (``[L, B, S_enc, KVH, D]``)
and the recurrent states (``[L, B, H, P, N]``; a hybrid's KV caches have
one entry per group), and each layer works on its ``[l]`` view, so
in-place writes land in the shared tensors.

On a mesh (``distributed/spmd.py``) every loop gathers its block's
resting parameters where the block runs (``spmd.gather_block``, inside
the remat region when training) and passes them straight on, so one
gathered block is alive at a time; a decode step's caches may be this
rank's shards (``spmd.layer_cache``: a sequence-split KV cache, SSM
states split by heads, gathered per layer).  A dense or SSM block takes
the residual stream whole at its entry (``spmd.model_whole``), inside
its remat region: under ``act_shard`` a dense block stores its output
as this rank's d-chunk, JAX's layout, so a checkpoint keeps the chunk.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
# ``constrain`` sits at the JAX package's sites; on the mesh path's local
# tensors (distributed/spmd.py) it acts only at the residual stream's.
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mamba2
from repro_torch.models import moe as moe_lib


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


def dense_block_pspec(cfg, frozen=False) -> dict:
    return {"attn_norm": {"scale": (None,)},
            "attn": attn_lib.attention_pspec(cfg.qk_norm, frozen),
            "mlp_norm": {"scale": (None,)},
            "mlp": layers.mlp_pspec(cfg.act, frozen)}


def dense_block(p, x, cfg, *, cache=None, positions=None, causal=True,
                mode=None):
    x = spmd.model_whole(x, cfg.d_model)
    h, new_cache = attn_lib.attention(
        p["attn"], layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, causal=causal, kv_cache=cache, mode=mode)
    x = x + h
    x = x + layers.mlp(p["mlp"],
                       layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps),
                       cfg.act, mode or cfg.linear_mode)
    if getattr(cfg, "act_shard", False):
        # JAX's site for the residual stream d-sharded between blocks
        # (remat carries shrink by the TP degree there).
        x = constrain(x, {0: "batch", 2: "model"}, carry=True)
    return x, new_cache


def init_moe_block(generator, cfg, dtype, *, device="cpu") -> dict:
    return {
        "attn_norm": layers.init_rmsnorm(cfg.d_model, device=device),
        "attn": attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dtype, device=device),
        "moe_norm": layers.init_rmsnorm(cfg.d_model, device=device),
        "moe": moe_lib.init_moe(generator, cfg.d_model, cfg.moe, dtype,
                                device=device),
    }


def moe_block_pspec(cfg, frozen=False) -> dict:
    return {"attn_norm": {"scale": (None,)},
            "attn": attn_lib.attention_pspec(cfg.qk_norm, frozen),
            "moe_norm": {"scale": (None,)},
            "moe": moe_lib.moe_pspec(cfg.moe)}


def moe_block(p, x, cfg, *, cache=None, positions=None, mode=None):
    """Returns (x, new_cache, aux_loss)."""
    h, new_cache = attn_lib.attention(
        p["attn"], layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, kv_cache=cache, mode=mode)
    x = x + h
    y, aux = moe_lib.moe(p["moe"],
                         layers.rmsnorm(p["moe_norm"], x, cfg.norm_eps),
                         cfg.moe, mode or cfg.linear_mode)
    return x + y, new_cache, aux["aux_loss"]


def init_ssm_block(generator, cfg, dtype, *, device="cpu") -> dict:
    return {
        "norm": layers.init_rmsnorm(cfg.d_model, device=device),
        "mamba": mamba2.init_mamba2(generator, cfg.d_model, cfg.ssm, dtype,
                                    device=device),
    }


def ssm_block_pspec(cfg) -> dict:
    return {"norm": {"scale": (None,)}, "mamba": mamba2.mamba2_pspec()}


def ssm_block(p, x, cfg, *, state=None, mode=None,
              return_final_state: bool = False):
    # zamba2's shared dense block may hand over its d-chunk.
    x = spmd.model_whole(x, cfg.d_model)
    h, new_state = mamba2.mamba2_block(
        p["mamba"], layers.rmsnorm(p["norm"], x, cfg.norm_eps), cfg,
        state=state, mode=mode, return_final_state=return_final_state)
    return x + h, new_state


def init_decoder_block(generator, cfg, dtype, *, device="cpu") -> dict:
    """An encoder-decoder model's decoder block: a dense block plus the
    cross-attention and its norm."""
    blk = init_dense_block(generator, cfg, dtype, device=device)
    blk["xattn_norm"] = layers.init_rmsnorm(cfg.d_model, device=device)
    blk["xattn"] = attn_lib.init_attention(
        generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, cfg.qk_norm, dtype, device=device)
    return blk


def decoder_block_pspec(cfg, frozen=False) -> dict:
    blk = dense_block_pspec(cfg, frozen)
    blk["xattn_norm"] = {"scale": (None,)}
    blk["xattn"] = attn_lib.attention_pspec(cfg.qk_norm, frozen)
    return blk


def decoder_block(p, x, cfg, *, cache=None, xattn_kv=None, xattn_cache=None,
                  positions=None, mode=None):
    """Causal self-attention (over ``cache`` when given), cross-attention
    to the encoder (its output ``xattn_kv``, or the projected
    ``xattn_cache``), then the MLP.  Returns x."""
    h, _ = attn_lib.attention(
        p["attn"], layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, causal=True, kv_cache=cache, mode=mode)
    x = x + h
    h, _ = attn_lib.attention(
        p["xattn"], layers.rmsnorm(p["xattn_norm"], x, cfg.norm_eps), cfg,
        xattn_kv=xattn_kv, xattn_cache=xattn_cache, mode=mode)
    x = x + h
    return x + layers.mlp(p["mlp"],
                          layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps),
                          cfg.act, mode or cfg.linear_mode)


def _arch(cfg) -> str:
    """The arch families (the JAX package's dispatch)."""
    at = cfg.arch_type
    if at in ("dense", "moe", "ssm", "hybrid", "encdec"):
        return at
    raise ValueError(f"unknown arch_type {at!r}")


def _n_groups(cfg) -> int:
    """A hybrid stack's groups of ``hybrid_attn_interval`` layers (the
    JAX package reshapes the layer axis into them)."""
    interval = cfg.hybrid_attn_interval
    if interval <= 0 or cfg.n_layers % interval:
        raise ValueError(f"hybrid stack: {cfg.n_layers} layers do not split "
                         f"into groups of {interval}")
    return cfg.n_layers // interval


def _block(blk, x, cfg, *, cache=None, positions=None, mode=None):
    """One dense or MoE block: (x, aux_loss)."""
    if cfg.arch_type == "moe":
        x, _, aux = moe_block(blk, x, cfg, cache=cache, positions=positions,
                              mode=mode)
        return x, aux
    x, _ = dense_block(blk, x, cfg, cache=cache, positions=positions,
                       mode=mode)
    return x, 0.0


def init_stack(generator, cfg, dtype=torch.bfloat16, *, device="cpu"
               ) -> dict:
    """``{"blocks": [per-layer dicts]}``; a hybrid stack adds its one
    ``shared_attn`` dense block; an encdec stack is ``{"encoder":
    [n_enc_layers dense blocks], "decoder": [n_layers decoder blocks]}``."""
    at = _arch(cfg)
    if at == "encdec":
        return {"encoder": [init_dense_block(generator, cfg, dtype,
                                             device=device)
                            for _ in range(cfg.n_enc_layers)],
                "decoder": [init_decoder_block(generator, cfg, dtype,
                                               device=device)
                            for _ in range(cfg.n_layers)]}
    init = {"moe": init_moe_block, "ssm": init_ssm_block,
            "hybrid": init_ssm_block}.get(at, init_dense_block)
    stack = {"blocks": [init(generator, cfg, dtype, device=device)
                        for _ in range(cfg.n_layers)]}
    if at == "hybrid":
        _n_groups(cfg)
        stack["shared_attn"] = init_dense_block(generator, cfg, dtype,
                                                device=device)
    return stack


def stack_pspec(cfg, frozen=False) -> dict:
    """``init_stack``'s tree of logical specs.  JAX stacks a leading
    ``"layers"`` axis (never sharded); here each layer of the list has
    its own copy of the block's specs."""
    at = _arch(cfg)
    if at == "encdec":
        return {"encoder": [dense_block_pspec(cfg, frozen)
                            for _ in range(cfg.n_enc_layers)],
                "decoder": [decoder_block_pspec(cfg, frozen)
                            for _ in range(cfg.n_layers)]}
    if at in ("ssm", "hybrid"):
        block = ssm_block_pspec(cfg)
    elif at == "moe":
        block = moe_block_pspec(cfg, frozen)
    else:
        block = dense_block_pspec(cfg, frozen)
    stack = {"blocks": [block] * cfg.n_layers}
    if at == "hybrid":
        stack["shared_attn"] = dense_block_pspec(cfg, frozen)
    return stack


def recurrent_stack(params, x, cfg, caches: dict, *, mode=None,
                    prefill: bool = False):
    """The ssm and hybrid stacks over their caches, updated in place:
    ``caches["ssm"]`` ``{ssm [L,B,H,P,N] f32, conv [L,B,K-1,C]}`` and, for
    a hybrid, ``caches["kv"]`` with one dense KV cache per group.  Group
    *g* starts with the shared attention block over KV cache *g*, then
    runs its SSM layers.  ``prefill`` runs each SSM layer's chunked scan
    over the whole prompt and stores its final states (the JAX package's
    ``_prefill_stack``); otherwise each layer takes one recurrent step
    (``decode_stack``).  A state split over 'model' (``spmd.StateShard``)
    is gathered for the step and this rank's shard of the new one kept.
    Returns the hidden states."""
    states = caches["ssm"]
    interval = cfg.hybrid_attn_interval
    for i, blk in enumerate(params["blocks"]):
        if cfg.arch_type == "hybrid" and i % interval == 0:
            x, _ = dense_block(spmd.gather_block(params["shared_attn"]), x,
                               cfg, mode=mode, cache=spmd.layer_cache(
                                   caches, "kv", i // interval))
        view = spmd.layer_cache(caches, "ssm", i)
        x, new = ssm_block(spmd.gather_block(blk), x, cfg,
                           state=None if prefill else spmd.gather_state(view),
                           mode=mode, return_final_state=prefill)
        for name, t in states.items():
            t[i].copy_(spmd.state_shard(view, name, new[name]))
    return x


_REMAT_POLICIES = ("nothing", "dots")


def _dots_saved():
    """Selective checkpoint contexts that keep the outputs of the
    matmuls without a batch dimension (``aten.mm``/``addmm``) and
    recompute everything else: JAX's
    ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _maybe_remat(fn, remat: bool, policy: str = "nothing"):
    """``fn`` rematerialized in the backward pass when ``remat``: one
    ``torch.utils.checkpoint`` region per call.  ``"nothing"`` keeps only
    the call's inputs, ``"dots"`` also the plain matmuls' outputs.  Remat
    changes memory, never numbers."""
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {_REMAT_POLICIES}, "
                         f"got {policy!r}")
    if not remat:
        return fn
    from torch.utils.checkpoint import checkpoint
    kw = {"context_fn": _dots_saved} if policy == "dots" else {}

    def rematted(*args):
        # The recompute runs fn again in the backward pass: on the mesh
        # scope of this call (spmd.bind_scope), whatever thread runs it.
        return checkpoint(spmd.bind_scope(fn), *args, use_reentrant=False,
                          **kw)

    return rematted


def apply_stack(params, x, cfg, *, positions=None, remat=False,
                remat_policy="nothing", mode=None, enc_out=None):
    """Full-sequence forward (no caches).  Returns (hidden, aux_loss): the
    MoE layers' summed Switch loss, 0 for the other stacks.  An encdec
    stack runs its decoder, cross-attending ``enc_out``
    (:func:`apply_encoder`).  ``remat`` checkpoints every block (a
    hybrid's shared attention block and each SSM block on its own, as
    the JAX package remats inside the group)."""
    at = _arch(cfg)

    def remat_fn(fn):
        return _maybe_remat(fn, remat, remat_policy)

    if at in ("ssm", "hybrid"):
        interval = cfg.hybrid_attn_interval
        shared = remat_fn(lambda blk, h: dense_block(
            spmd.gather_block(blk), h, cfg, positions=positions,
            mode=mode)[0])
        ssm = remat_fn(lambda blk, h: ssm_block(spmd.gather_block(blk), h,
                                                cfg, mode=mode)[0])
        for i, blk in enumerate(params["blocks"]):
            if at == "hybrid" and i % interval == 0:
                x = shared(params["shared_attn"], x)
            x = ssm(blk, x)
        return x, 0.0
    if at == "encdec":
        if enc_out is None:
            raise ValueError("an encdec stack needs the encoder output "
                             "(enc_out)")
        dec = remat_fn(lambda blk, h: decoder_block(
            spmd.gather_block(blk), h, cfg, xattn_kv=enc_out,
            positions=positions, mode=mode))
        for blk in params["decoder"]:
            x = dec(blk, x)
        return x, 0.0
    block = remat_fn(lambda blk, h: _block(spmd.gather_block(blk), h, cfg,
                                           positions=positions, mode=mode))
    aux = 0.0
    for blk in params["blocks"]:
        x, a = block(blk, x)
        aux = aux + a
    return x, aux


def apply_encoder(params, frames, cfg, *, remat=False, mode=None):
    """Bidirectional encoder over (stub) frame embeddings [B, S_enc, d];
    ``remat`` checkpoints every block."""
    enc = _maybe_remat(lambda blk, h: dense_block(
        spmd.gather_block(blk), h, cfg, causal=False, mode=mode)[0], remat)
    for blk in params["encoder"]:
        frames = enc(blk, frames)
    return frames


def precompute_cross_kv(params, enc_out, cfg, mode=None):
    """Every decoder layer's cross K/V from the encoder output, once per
    prefill: ``([L, B, S_enc, KVH, D], [L, B, S_enc, KVH, D])``."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    mode = mode or cfg.linear_mode
    ks, vs = [], []
    for blk in params["decoder"]:
        for name, out in (("k", ks), ("v", vs)):
            out.append(layers.dense(spmd.gather_block(blk["xattn"][name]),
                                    enc_out, mode,
                                    path=f"xattn/{name}").reshape(
                b, s, cfg.n_kv_heads, hd))
    return torch.stack(ks), torch.stack(vs)


def _layer(pages, i):
    """Layer ``i``'s view of a stacked pool leaf (tensor or QTensor)."""
    if isinstance(pages, quant.QTensor):
        return quant.QTensor(pages.q[i], pages.scale[i])
    return pages[i]


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                device="cpu", enc_out=None) -> dict:
    """Zero caches for ``Engine.generate``.  Attention stacks get dense KV
    caches ``{"kv": {k, v, len[, k_scale, v_scale]}}`` with a leading
    layer axis (``len`` is ``[L]`` int32).  An int8 cache
    (``cfg.kv_cache_dtype == "int8"``) stores codes with bf16
    per-token-head scales; otherwise the model's ``dtype``.  A
    sliding-window model gets a ring of ``min(max_len, window)``
    positions, always in ``dtype`` (a window turns the int8 cache off, as
    in the JAX package).  An ssm stack gets ``{"ssm": {ssm, conv}}``
    (``[L, ...]`` recurrent states: f32, the conv's in ``dtype``); a
    hybrid both, its ``kv`` with one entry per group.  An encdec stack
    gets its decoder's KV caches and zero ``cross_k`` / ``cross_v``
    ``[L, B, S_enc, KVH, D]`` in ``dtype`` (never int8), shaped by
    ``enc_out`` [B, S_enc, d]."""
    at = _arch(cfg)
    if at == "encdec" and enc_out is None:
        raise ValueError("encdec caches need the encoder output's shape "
                         "(enc_out)")
    caches = {}
    if at in ("ssm", "hybrid"):
        st = mamba2.init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype,
                                     device=device)
        caches["ssm"] = {name: t.new_zeros((cfg.n_layers, *t.shape))
                         for name, t in st.items()}
        if at == "ssm":
            return caches
    n = _n_groups(cfg) if at == "hybrid" else cfg.n_layers
    kv_len = max_len
    if cfg.sliding_window is not None:
        kv_len = min(max_len, cfg.sliding_window)
    int8 = (getattr(cfg, "kv_cache_dtype", "bf16") == "int8"
            and cfg.sliding_window is None)
    shape = (n, batch, kv_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    store = torch.int8 if int8 else dtype
    kv = {"k": torch.zeros(shape, dtype=store, device=device),
          "v": torch.zeros(shape, dtype=store, device=device),
          "len": torch.zeros(n, dtype=torch.int32, device=device)}
    if int8:
        for name in ("k_scale", "v_scale"):
            kv[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=device)
    caches["kv"] = kv
    if at == "encdec":
        cross = (n, batch, enc_out.shape[1], cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        caches["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        caches["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return caches


def decode_stack(params, x, cfg, caches: dict, *, positions=None,
                 mode=None):
    """Decode (S == 1) or prefill (S > 1) pass through the stack over a
    paged pool or a dense cache.  ``caches["kv"]`` holds the pool ``{k,
    v}`` or the dense cache ``{k, v, len[, k_scale, v_scale]}``, each with
    a leading layer axis; a pool's block tables / lengths / write mask /
    chunk lengths / decode pages per split are layer-invariant.  An ssm or
    hybrid stack takes one recurrent step (S == 1) over its states
    (``recurrent_stack``); an encdec decoder cross-attends
    ``caches["cross_k"/"cross_v"]``.  ``positions`` (a prefill's, e.g.
    M-RoPE's [3, B, S]) default to the cache's.  Caches are updated in
    place; returns (hidden, caches)."""
    at = _arch(cfg)
    if at in ("ssm", "hybrid"):
        return recurrent_stack(params, x, cfg, caches, mode=mode), caches
    if "block_tables" not in caches:
        for i, blk in enumerate(params["decoder" if at == "encdec"
                                       else "blocks"]):
            cache = spmd.layer_cache(caches, "kv", i)
            if at == "encdec":
                x = decoder_block(spmd.gather_block(blk), x, cfg,
                                  cache=cache, positions=positions,
                                  mode=mode,
                                  xattn_cache=spmd.cross_cache(caches, i))
            else:
                x, _ = _block(spmd.gather_block(blk), x, cfg, cache=cache,
                              positions=positions, mode=mode)
        return x, caches
    shared = {key: caches[key]
              for key in ("block_tables", "lens", "write_mask", "chunk_len",
                          "pf_has_past", "split_pages")
              if key in caches}
    pages = caches["kv"]
    for i, blk in enumerate(params["blocks"]):
        kv = dict(k=_layer(pages["k"], i), v=_layer(pages["v"], i), **shared)
        x, _ = _block(spmd.gather_block(blk), x, cfg, cache=kv,
                      positions=positions, mode=mode)
    return x, caches
