"""LM wrapper: embeddings -> stack -> final norm -> head (port of the
serving entry points of ``repro/models/model.py`` for every family: the
dense and MoE decoders, the ssm and hybrid state-space stacks, the
encoder-decoder (whisper) and M-RoPE (qwen2-vl)).

  init(cfg, generator, device)                 -> params
  freeze_params(params, a_scale, plan)         -> deployed params
  forward(params, batch, cfg, train=...)       -> (hidden, aux)
  loss_fn(params, batch, cfg)                  -> (loss, metrics) [chunked CE]
  logits_fn(params, h, cfg, mode)              -> logits (padded vocab masked)
  prefill(params, batch, cfg, max_len)         -> (last logits, dense caches)
  prefill_paged(params, batch, cfg, ...)       -> (last logits, pages)
  prefill_chunk(params, tokens, cfg, ...)      -> (last logits, pages)
  decode_step(params, batch, caches, cfg)      -> (logits, caches)

Batch keys (which are present depends on the arch's frontend):
  tokens    [B, S] integer ids
  embeds    [B, S, d] (vision_stub: token and patch embeddings merged
            upstream; they replace the token embedding)
  frames    [B, S_enc, d] (audio_stub: the encoder's frame embeddings)
  positions [B, S] or [3, B, S] (M-RoPE t/h/w) integer ids, optional
  labels    [B, S] integer next-token ids, -1 where no loss is taken
  length    the true prompt length of a right-padded ``tokens`` batch
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
    if cfg.arch_type == "encdec":
        p["enc_final_norm"] = layers.init_rmsnorm(cfg.d_model, device=dev)
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
    """Deploy transform: every weight-stationary linear, MoE expert banks
    included, is frozen by its plan-resolved backend (int8 with static
    per-channel scales for deployed backends, untouched master params for
    float ones).  Layer paths are the JAX package's
    ('stack/blocks/attn/q', 'stack/blocks/moe', 'lm_head', ...): the
    per-layer list adds no path component, so one plan resolves the same
    way in both packages.  A bank ``{gate, up, down}`` ``[E, K, N]``
    follows one rule (its three products share one dispatch buffer) and
    becomes ``{gate,up,down}_q``, ``{..}_scale`` ``[E, N]`` and one
    scalar ``a_scale``."""
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
            if {"gate", "up", "down"} <= set(node) \
                    and isinstance(node["gate"], torch.Tensor):
                return freeze_bank(path, node)
            return {k: walk(f"{path}/{k}" if path else k, v)
                    for k, v in node.items()}
        return node

    def freeze_bank(path, node):
        rule = plan.rule_for(path)
        banks = ("gate", "up", "down")
        out = {k: walk(f"{path}/{k}", v) for k, v in node.items()
               if k not in banks}
        if not backend_lib.get_backend(rule.backend).deploys_int8:
            return {**out, **{k: node[k] for k in banks}}
        for k in banks:
            f = freeze_with(rule, {"w": node[k]})
            out[f"{k}_q"] = f["w_q"]
            out[f"{k}_scale"] = f["w_scale"]
        out["a_scale"] = f["a_scale"]
        return out

    return walk("", params)


def _embed_inputs(params, batch, cfg):
    """The stack's input: ``embeds`` (cast to the model dtype) when the
    batch has them, else the token embedding."""
    if "embeds" in batch:
        return batch["embeds"].to(_dtype(cfg))
    return layers.embed(params["embed"], batch["tokens"])


def _encoder_out(params, batch, cfg, remat=False, mode=None):
    """The encoder over ``batch["frames"]``, final-normed."""
    if "frames" not in batch:
        raise ValueError("an encdec model needs batch['frames'], the "
                         "encoder's frame embeddings [B, S_enc, d_model]")
    h = transformer.apply_encoder(params["stack"],
                                  batch["frames"].to(_dtype(cfg)), cfg,
                                  remat=remat, mode=mode)
    return layers.rmsnorm(params["enc_final_norm"], h, cfg.norm_eps)


def forward(params, batch, cfg, *, train: bool = False,
            remat: bool | None = None, remat_policy: str = "nothing",
            mode=None):
    """Full-sequence forward to final hidden states.  Returns (h, aux).
    ``remat`` (default: ``train``) checkpoints every block under
    ``remat_policy`` (``"nothing"`` or ``"dots"``)."""
    remat = train if remat is None else remat
    x = _embed_inputs(params, batch, cfg)
    enc_out = (_encoder_out(params, batch, cfg, remat=remat, mode=mode)
               if cfg.arch_type == "encdec" else None)
    h, aux = transformer.apply_stack(params["stack"], x, cfg,
                                     positions=batch.get("positions"),
                                     remat=remat, remat_policy=remat_policy,
                                     mode=mode, enc_out=enc_out)
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


def loss_fn(params, batch, cfg, *, loss_chunk: int = 256,
            remat_policy: str = "nothing", mode=None,
            aux_weight: float = 0.01):
    """Chunked-softmax LM loss over the training forward (remat on): the
    f32 logits are made ``[B, loss_chunk, V]`` at a time, never ``[B, S,
    V]``, the padding columns masked to -1e30, positions with ``labels <
    0`` left out.  Returns ``(ce + aux_weight * aux, {"ce", "aux",
    "tokens"})``; the sequence must be a multiple of the chunk."""
    h, aux = forward(params, batch, cfg, train=True,
                     remat_policy=remat_policy, mode=mode)
    labels = batch["labels"].long()
    b, s = labels.shape
    chunk = min(loss_chunk, s)
    if s % chunk:
        raise ValueError(f"loss_fn needs the sequence ({s}) to be a "
                         f"multiple of loss_chunk ({chunk})")
    head = _head_weight(params, cfg)
    dev = h.device
    pad = (torch.arange(cfg.padded_vocab, device=dev) >= cfg.vocab
           if cfg.padded_vocab != cfg.vocab else None)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for c0 in range(0, s, chunk):
        lc = labels[:, c0:c0 + chunk]
        logits = layers.dense(head, h[:, c0:c0 + chunk], "exact",
                              dtype=torch.float32, path="lm_head")
        if pad is not None:
            logits = torch.where(pad, -1e30, logits)
        logz = torch.logsumexp(logits, dim=-1)
        # A negative label indexes from the end, as JAX's take_along_axis
        # does; its term is multiplied by 0.
        idx = torch.where(lc < 0, lc + cfg.padded_vocab, lc)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        valid = (lc >= 0).to(torch.float32)
        tot = tot + ((logz - gold) * valid).sum()
        cnt = cnt + valid.sum()
    ce = tot / torch.clamp_min(cnt, 1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": cnt}


def prefill(params, batch, cfg, *, max_len: int, mode=None):
    """Process the prompt into fresh dense caches of ``max_len`` positions
    and return the last position's logits ``[B, 1, V]`` and the caches.

    ``batch["length"]`` (optional, an int or a 0-d integer tensor) marks
    the true prompt length when ``tokens`` is right-padded to a bucket
    (``Engine.bucket``): logits are taken at ``length - 1`` and the write
    cursor is rewound past the pads, so decode overwrites them and the
    length masks exclude them: dense archs only, as in the JAX package
    (MoE capacity counts the pads; SSM state would integrate them).  The
    JAX package's ``_prefill_stack`` for dense, MoE and encdec archs is
    the stack pass over the dense cache, ``transformer.decode_stack``; ssm
    and hybrid archs take :func:`_prefill_stack`.

    An encdec model runs its encoder over ``batch["frames"]``, projects
    every decoder layer's cross K/V once (``precompute_cross_kv``) into
    the caches, then runs the decoder over ``tokens``.  ``embeds`` replace
    the token embedding and ``positions`` (M-RoPE's [3, B, S]) reach every
    self-attention layer."""
    if batch.get("length") is not None and cfg.arch_type != "dense":
        raise ValueError("bucketed prefill (batch['length']) is "
                         "dense-attention only")
    x = _embed_inputs(params, batch, cfg)
    dev = x.device
    b, s = x.shape[:2]
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = _encoder_out(params, batch, cfg, mode=mode)
    caches = transformer.init_caches(cfg, b, max_len, _dtype(cfg),
                                     device=dev, enc_out=enc_out)
    if enc_out is not None:
        caches["cross_k"], caches["cross_v"] = \
            transformer.precompute_cross_kv(params["stack"], enc_out, cfg,
                                            mode=mode)
    if cfg.arch_type in ("ssm", "hybrid"):
        h, caches = _prefill_stack(params["stack"], x, cfg, caches,
                                   mode=mode)
    else:
        h, caches = transformer.decode_stack(
            params["stack"], x, cfg, caches,
            positions=batch.get("positions"), mode=mode)
    length = batch.get("length")
    if length is None:
        h_last = h[:, -1:]
    else:
        length = torch.as_tensor(length, device=dev).to(torch.int32)
        h_last = h.index_select(1, (length.long() - 1).reshape(1))
        caches["kv"]["len"].sub_((s - length).to(torch.int32))
    h = layers.rmsnorm(params["final_norm"], h_last, cfg.norm_eps)
    return logits_fn(params, h, cfg, mode), caches


def _prefill_stack(params, x, cfg, caches, *, mode=None):
    """The ssm and hybrid stacks' prefill: every SSM layer runs the
    chunked SSD scan over the whole prompt with ``return_final_state``
    and leaves its recurrent and conv states in ``caches`` (in place); a
    hybrid's shared attention block fills its group's KV cache.  (A
    decode step's recurrence reads one token, so the prompt cannot go
    through ``decode_stack``.)  The prompt length must be a multiple of
    ``min(cfg.ssm.chunk, S)``.  Returns (hidden, caches)."""
    return transformer.recurrent_stack(params, x, cfg, caches, mode=mode,
                                       prefill=True), caches


def prefill_paged(params, batch, cfg, *, pages, block_table, max_len: int,
                  mode=None):
    """Prefill ONE request and scatter its K/V into the pool pages (in
    place).  The dense ``[1, max_len]`` cache built by :func:`prefill` is
    scratch; ``block_table`` is ``[max_len // block_size]`` int32 (entries
    past the prompt's blocks point at the null block).  Returns
    ``(last logits, pages)``."""
    from repro_torch.serve import kv_pool  # serve layers on models
    logits, caches = prefill(params, batch, cfg, max_len=max_len, mode=mode)
    return logits, kv_pool.pack_prompt(pages, caches["kv"], block_table)


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
    """One token for every row.  Returns (logits [B, 1, V], caches).
    Without ``batch["positions"]`` the positions follow the cache's length
    (under M-RoPE the same on every axis), as in the JAX package."""
    x = _embed_inputs(params, batch, cfg)
    h, caches = transformer.decode_stack(params["stack"], x, cfg, caches,
                                         positions=batch.get("positions"),
                                         mode=mode)
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return logits_fn(params, h, cfg, mode), caches
