"""Attention: GQA with RoPE and qk-norm over full sequences and the paged
KV pool (port of the main-path branches of ``repro/models/attention.py``).

Regimes:

* ``attend_full``          -- materialized scores (no cache).
* ``attend_decode_paged``  -- one query token per row over the paged pool;
  ``impl="reference"`` gathers the table-referenced pages and runs
  ``attend_decode`` / ``attend_decode_int8``; ``impl="fused"``
  (``DeploymentPlan(paged_attn=True)``) runs the split-KV decode kernel.
* ``attend_prefill_paged`` -- a causal prompt chunk over the paged pool,
  writing the chunk's K/V into its pages (in-kernel for ``impl="fused"``).
* the dense (non-paged) KV cache of ``Engine.generate``: a prefill
  attends its own K/V (``attend_full``) and writes the cache, a decode
  attends the cache (``attend_decode`` / ``attend_decode_int8``).

Caches and the pool are updated in place (the JAX package returns new
ones).  Sliding windows and prompts over 2048 tokens
(``attend_chunked``) are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import quant
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qk_norm: bool = False,
                   dtype=torch.bfloat16, *, device="cpu") -> dict:
    def dense(i, o, scale=None):
        return layers.init_dense(generator, i, o, dtype, scale,
                                 device=device)

    p = {
        "q": dense(d_model, n_heads * head_dim),
        "k": dense(d_model, n_kv_heads * head_dim),
        "v": dense(d_model, n_kv_heads * head_dim),
        "o": dense(n_heads * head_dim, d_model, (n_heads * head_dim) ** -0.5),
    }
    if qk_norm:
        p["q_norm"] = layers.init_rmsnorm(head_dim, device=device)
        p["k_norm"] = layers.init_rmsnorm(head_dim, device=device)
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH*groups, D] for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def attend_full(q, k, v, *, causal: bool) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,KVH,D] -> [B,Sq,H,D], materialized scores."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    if causal:
        ok = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        scores = torch.where(ok[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend_decode(q, k_cache, v_cache, kv_len_mask=None) -> torch.Tensor:
    """q [B, Sq, H, D] against K/V [B, S, KVH, D] (no causal constraint)."""
    b, sq, h, d = q.shape
    kvh = k_cache.shape[2]
    groups = h // kvh
    qh = q.reshape(b, sq, kvh, groups, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                          k_cache.to(torch.float32)) / math.sqrt(d)
    if kv_len_mask is not None:
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores,
                             NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v_cache.to(torch.float32))
    out = out / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact batched int8 x int8 -> int32 (float64 accumulation)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def attend_decode_int8(q, k_q, k_s, v_q, v_s, kv_len_mask=None
                       ) -> torch.Tensor:
    """Fully-integer decode attention over an int8 KV cache (KIVI-style):
    q and the v-scale-folded probabilities are quantized too, so both
    contractions are int8 x int8 -> int32."""
    b, sq, h, d = q.shape
    kvh = k_q.shape[2]
    groups = h // kvh
    qh = q.reshape(b, sq, kvh, groups, d).to(torch.float32)
    q_scale = torch.clamp_min(qh.abs().amax(dim=-1), 1e-8) / 127.0
    qq = torch.clamp(torch.round(qh / q_scale[..., None]), -127, 127).to(
        torch.int8)
    s_int = _int_dot(
        qq.permute(0, 2, 1, 3, 4).reshape(b, kvh, sq * groups, d),
        k_q.permute(0, 2, 3, 1)).reshape(b, kvh, sq, groups, -1)
    qs = q_scale.reshape(b, sq, kvh, groups).permute(0, 2, 1, 3)
    scores = s_int.to(torch.float32) * qs[..., None] \
        * k_s.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(d)
    if kv_len_mask is not None:
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores,
                             NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    p_fold = p * v_s.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    p_scale = torch.clamp_min(p_fold.amax(dim=-1), 1e-8) / 127.0
    pq = torch.clamp(torch.round(p_fold / p_scale[..., None]), 0, 127).to(
        torch.int8)
    o_int = _int_dot(pq.reshape(b, kvh, sq * groups, -1),
                     v_q.permute(0, 2, 1, 3)).reshape(b, kvh, sq, groups, d)
    out = o_int.to(torch.float32) * p_scale[..., None]
    out = out / l[..., None]
    out = out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def gather_pages(pages, block_tables, n_valid=None):
    """pages [NB, BS, ...] (tensor or int8 QTensor), block_tables [B, W] ->
    each row's cache as a contiguous [B, W*BS, ...] view.  With ``n_valid``
    given only the first ``ceil(max(n_valid) / BS)`` table columns are
    gathered."""
    bt = block_tables.long()
    if n_valid is not None:
        bs = (pages.q if isinstance(pages, quant.QTensor) else pages).shape[1]
        nmax = int(n_valid.max()) if n_valid.numel() else 0
        w = min(max(-(-nmax // bs), 1), bt.shape[1])
        bt = bt[:, :w]
    if isinstance(pages, quant.QTensor):
        g = pages[bt]
        b, nbr, bs = g.q.shape[:3]
        return quant.QTensor(
            g.q.reshape(b, nbr * bs, *g.q.shape[3:]),
            g.scale.reshape(b, nbr * bs, *g.scale.shape[3:]))
    g = pages[bt]
    b, nbr, bs = g.shape[:3]
    return g.reshape(b, nbr * bs, *g.shape[3:])


def attend_decode_paged(q, k_pages, v_pages, block_tables, n_valid, *,
                        impl: str = "reference", kv_splits: int | None = None
                        ) -> torch.Tensor:
    """Decode attention over a paged KV pool.  q [B, 1, H, D]; pages
    [NB, BS, KVH, D] tensors or int8 QTensors; block_tables [B, W];
    n_valid [B] live positions per row."""
    if impl == "fused":
        from repro_torch.kernels.paged_attention import ops as paged_ops
        return paged_ops.paged_attention(q, k_pages, v_pages, block_tables,
                                         n_valid, kv_splits=kv_splits)
    if impl != "reference":
        raise ValueError(f"impl must be 'reference' or 'fused', got "
                         f"{impl!r}")
    kg = gather_pages(k_pages, block_tables, n_valid)
    vg = gather_pages(v_pages, block_tables, n_valid)
    s = kg.shape[1]
    mask = torch.arange(s, device=q.device)[None, :] < n_valid[:, None]
    if isinstance(kg, quant.QTensor):
        return attend_decode_int8(q, kg.q, kg.scale[..., 0], vg.q,
                                  vg.scale[..., 0], mask)
    return attend_decode(q, kg, vg, mask)


def attend_prefill_paged(q, k, v, k_pages, v_pages, block_tables, pos,
                         n_tok, write_mask=None, *, impl: str = "reference",
                         has_past: bool = True):
    """Causal-chunk prefill attention over a paged KV pool.  q [B, C, H, D];
    k/v [B, C, KVH, D] the in-hand chunk (post-RoPE); pos [B] page-aligned
    chunk starts; n_tok [B] valid tokens this chunk.  The chunk's K/V is
    written into its pages in place; returns ``(out [B, C, H, D],
    k_pages, v_pages)``."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    if impl == "fused":
        return paged_ops.paged_prefill(q, k, v, k_pages, v_pages,
                                       block_tables, pos, n_tok, write_mask,
                                       has_past=has_past)
    if impl != "reference":
        raise ValueError(f"impl must be 'reference' or 'fused', got "
                         f"{impl!r}")
    b, c, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    dev = q.device
    pos = pos.to(device=dev, dtype=torch.int32)
    n_tok = n_tok.to(device=dev, dtype=torch.int32)
    if has_past:
        kg = gather_pages(k_pages, block_tables)
        vg = gather_pages(v_pages, block_tables)
        if isinstance(kg, quant.QTensor):
            kg, vg = kg.dequant(), vg.dequant()
        sp = kg.shape[1]
        k_all = torch.cat([kg.to(torch.float32), k.to(torch.float32)], 1)
        v_all = torch.cat([vg.to(torch.float32), v.to(torch.float32)], 1)
    else:
        sp = 0
        k_all = k.to(torch.float32)
        v_all = v.to(torch.float32)
    k_all = _repeat_kv(k_all, groups)
    v_all = _repeat_kv(v_all, groups)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k_all) / math.sqrt(d)
    kp = torch.arange(sp + c, device=dev)
    past_ok = (kp[None, :] < pos[:, None]) & (kp < sp)[None, :]
    ci = torch.arange(c, device=dev)
    self_ok = ((kp[None, None, :] >= sp)
               & (kp[None, None, :] - sp <= ci[None, :, None])
               & ((kp[None, :] - sp < n_tok[:, None])[:, None, :]))
    ok = past_ok[:, None, :] | self_ok                 # [B, C, Sp+C]
    scores = torch.where(ok[:, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    prob = torch.where(ok[:, None], torch.exp(scores - m), 0.0)
    l = prob.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", prob / torch.clamp_min(l, 1e-30),
                       v_all).to(q.dtype)
    wm = None if write_mask is None else write_mask.to(dev).bool()
    paged_ops.write_chunk_pages(k_pages, k, block_tables, pos, n_tok, wm)
    paged_ops.write_chunk_pages(v_pages, v, block_tables, pos, n_tok, wm)
    return out, k_pages, v_pages


def _attend_dense_cache(q, k, v, kv_cache: dict) -> torch.Tensor:
    """The dense (non-paged) KV cache: ``kv_cache`` holds ``k``/``v``
    ``[B, S_max, KVH, D]`` (int8 codes with bf16 ``k_scale``/``v_scale``
    ``[B, S_max, KVH]`` for an int8 cache) and ``len``, a 0-d int32 tensor
    shared by the batch.  A prefill (S > 1) attends the in-hand K/V
    (the cache holds nothing yet) and writes them at ``len``; a decode
    writes one slot and attends the cache up to it.  Writes and the
    ``len`` advance happen in place, on the device."""
    s = q.shape[1]
    length = kv_cache["len"]
    idx = length.long() + torch.arange(s, device=q.device)
    int8 = "k_scale" in kv_cache
    if int8:
        for name, x in (("k", k), ("v", v)):
            codes, scale = quantize_kv(x)
            kv_cache[name].index_copy_(1, idx, codes)
            kv_cache[f"{name}_scale"].index_copy_(
                1, idx, scale.to(kv_cache[f"{name}_scale"].dtype))
    else:
        kv_cache["k"].index_copy_(1, idx, k.to(kv_cache["k"].dtype))
        kv_cache["v"].index_copy_(1, idx, v.to(kv_cache["v"].dtype))
    if s > 1:
        out = attend_full(q, k, v, causal=True)
    else:
        s_cache = kv_cache["k"].shape[1]
        mask = (torch.arange(s_cache, device=q.device) < length + s)[None]
        if int8:
            out = attend_decode_int8(q, kv_cache["k"], kv_cache["k_scale"],
                                     kv_cache["v"], kv_cache["v_scale"],
                                     mask)
        else:
            out = attend_decode(q, kv_cache["k"], kv_cache["v"], mask)
    length.add_(s)
    return out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] -> (int8 codes, [..., H] bf16 per-token-head scales).
    The scale is rounded to its bf16 storage precision before quantizing,
    so quantize and dequantize use the identical value."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8).to(
        torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.to(torch.float32)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def attention(p: dict, x: torch.Tensor, cfg, *, kv_cache: dict | None = None,
              mode=None, chunked_threshold: int = 2048):
    """Causal self-attention layer.  Returns (output [B, S, d_model], updated
    cache or None).  ``kv_cache`` is None (full-sequence forward), a dense
    cache {k, v, len[, k_scale, v_scale]} (``_attend_dense_cache``) or a
    paged-pool view {k, v, block_tables, lens[, write_mask, chunk_len,
    pf_has_past]}: S == 1 decodes one token per row, S > 1 prefills (a
    whole prompt into a dense cache, a chunk into the pool)."""
    mode = mode or cfg.linear_mode
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    if cfg.sliding_window is not None or cfg.mrope_sections is not None:
        raise NotImplementedError(
            "sliding-window and M-RoPE attention are not ported yet")

    x_in = x
    if backend_lib.residency_enabled(mode):
        x_in = backend_lib.shared_quant((p["q"], p["k"], p["v"]), x)

    q = layers.dense(p["q"], x_in, mode, dtype=dt,
                     path="attn/q").reshape(b, s, cfg.n_heads, hd)
    k = layers.dense(p["k"], x_in, mode, dtype=dt,
                     path="attn/k").reshape(b, s, cfg.n_kv_heads, hd)
    v = layers.dense(p["v"], x_in, mode, dtype=dt,
                     path="attn/v").reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)

    positions = torch.arange(s, device=x.device)[None, :]
    if kv_cache is not None:
        positions = positions + (kv_cache["lens"][:, None]
                                 if "lens" in kv_cache else kv_cache["len"])
    ang = layers.rope_angles(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, ang)
    k = layers.apply_rope(k, ang)

    def out_proj(o):
        return layers.dense(p["o"], o.reshape(b, s, cfg.n_heads * hd), mode,
                            path="attn/o").to(dt)

    if kv_cache is None:
        if s > chunked_threshold:
            raise NotImplementedError(
                f"sequence {s} > {chunked_threshold}: chunked attention is "
                "not ported yet")
        return out_proj(attend_full(q, k, v, causal=True)), None

    if "block_tables" not in kv_cache:
        if s > chunked_threshold:
            raise NotImplementedError(
                f"prefill of {s} > {chunked_threshold} tokens: chunked "
                "attention is not ported yet")
        return out_proj(_attend_dense_cache(q, k, v, kv_cache)), kv_cache
    bt = kv_cache["block_tables"]
    lens = kv_cache["lens"]
    wm = kv_cache.get("write_mask")
    impl = "fused" if backend_lib.paged_attn_enabled(mode) else "reference"
    if s > 1:
        out, k_pages, v_pages = attend_prefill_paged(
            q, k, v, kv_cache["k"], kv_cache["v"], bt, lens,
            kv_cache["chunk_len"], wm, impl=impl,
            has_past=kv_cache.get("pf_has_past", True))
        return out_proj(out), {"k": k_pages, "v": v_pages}

    # Single-token decode: write the new K/V into page slot lens[b], then
    # attend.  Plain indexing (outside any kernel, like the JAX package);
    # rows with write_mask False write into the null block 0.
    k_pages, v_pages = kv_cache["k"], kv_cache["v"]
    int8_pool = isinstance(k_pages, quant.QTensor)
    bs_blk = (k_pages.q if int8_pool else k_pages).shape[1]
    slot = torch.clamp_max(lens // bs_blk, bt.shape[1] - 1).long()
    page = torch.gather(bt.long(), 1, slot[:, None])[:, 0]
    off = (lens % bs_blk).long()
    if wm is not None:
        page = torch.where(wm, page, 0)
    if int8_pool:
        k_q, k_s = quantize_kv(k[:, 0])
        v_q, v_s = quantize_kv(v[:, 0])
        k_pages.q[page, off] = k_q
        k_pages.scale[page, off] = k_s[..., None]
        v_pages.q[page, off] = v_q
        v_pages.scale[page, off] = v_s[..., None]
    else:
        k_pages[page, off] = k[:, 0].to(k_pages.dtype)
        v_pages[page, off] = v[:, 0].to(v_pages.dtype)
    wrote = (torch.ones_like(lens) if wm is None else wm.to(lens.dtype))
    out = attend_decode_paged(q, k_pages, v_pages, bt, lens + wrote,
                              impl=impl)
    return out_proj(out), {"k": k_pages, "v": v_pages}
