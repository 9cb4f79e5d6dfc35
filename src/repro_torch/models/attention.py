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
* ``attend_chunked``     -- the double-chunked online-softmax loop of
  long prompts (over ``chunked_threshold`` tokens); with a sliding window
  each query chunk reads only its trailing KV band.
* the dense (non-paged) KV cache of ``Engine.generate``: a prefill
  attends its own K/V (``attend_full`` / ``attend_chunked``) and writes
  the cache, a decode attends the cache (``attend_decode`` /
  ``attend_decode_int8``).  A sliding-window model keeps a ring cache of
  ``min(max_len, window)`` positions.

Cross-attention (the encoder-decoder family) attends the encoder's K/V
without a mask: ``attend_full`` / ``attend_chunked`` in the full-sequence
forward, ``attend_decode`` (or non-causal ``attend_chunked`` past
``chunked_threshold``) over K/V projected once at prefill.  M-RoPE rotates
by [3, B, S] t/h/w positions in frequency bands (``layers.rope_angles``).

Caches and the pool are updated in place (the JAX package returns new
ones).
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as device_lib
from repro_torch.core import backend as backend_lib
from repro_torch.core import quant
from repro_torch.distributed import collectives, spmd
# ``constrain`` sits at the JAX package's sites; it redistributes DTensors
# only, so on the mesh path (local tensors, distributed/spmd.py) it is inert.
from repro_torch.distributed.sharding import constrain
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


def attention_pspec(qk_norm: bool = False, frozen: bool = False) -> dict:
    p = {"q": layers.dense_pspec("embed", "q_heads", frozen),
         "k": layers.dense_pspec("embed", "kv_heads", frozen),
         "v": layers.dense_pspec("embed", "kv_heads", frozen),
         "o": layers.dense_pspec("q_heads", "embed", frozen)}
    if qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH*groups, D] for GQA."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def _mask_value(q_pos, k_pos, causal: bool, window: int | None):
    ok = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    return ok


def attend_full(q, k, v, *, causal: bool, window: int | None = None,
                q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,KVH,D] -> [B,Sq,H,D], materialized scores."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = _mask_value(q_pos, k_pos, causal, window)
    scores = torch.where(ok[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend_chunked(q, k, v, *, causal: bool, window: int | None = None,
                   q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style double-chunked attention, O(q_chunk * kv_chunk) live
    scores: the JAX package's loops (query chunks outer, KV chunks inner,
    f32 online softmax) in the same order.  With a sliding window each
    query chunk reads only its trailing KV band of ``ceil((window +
    q_chunk) / kv_chunk)`` KV chunks.  ``S`` must be a ``q_chunk``
    multiple, as there."""
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    if s % q_chunk:
        raise ValueError(f"attend_chunked needs S % q_chunk == 0, got S={s}, "
                         f"q_chunk={q_chunk}")
    dev = q.device
    full_band = -(-sk // kv_chunk) * kv_chunk
    band = full_band
    if window is not None:
        band = min(-(-(window + q_chunk) // kv_chunk) * kv_chunk, full_band)
    pad_k = band                      # left pad: every band slice in range
    k_p = torch.nn.functional.pad(k, (0, 0, 0, 0, pad_k, 0))
    v_p = torch.nn.functional.pad(v, (0, 0, 0, 0, pad_k, 0))
    k_p = constrain(k_p, {0: "batch", 2: "model"})
    v_p = constrain(v_p, {0: "batch", 2: "model"})
    q = constrain(q, {0: "batch", 2: "model"})
    q_pos = band - q_chunk + torch.arange(q_chunk, device=dev)
    outs = []
    for i in range(s // q_chunk):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_end = (i + 1) * q_chunk
        band_start = (q_end - band if causal or window is not None
                      else sk - band)
        lo = band_start + pad_k
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for j in range(band // kv_chunk):
            kc = _repeat_kv(k_p[:, lo + j * kv_chunk:lo + (j + 1) * kv_chunk],
                            groups)
            vc = _repeat_kv(v_p[:, lo + j * kv_chunk:lo + (j + 1) * kv_chunk],
                            groups)
            scores = torch.einsum("bqhd,bkhd->bhqk", qc, kc).to(
                torch.float32) / math.sqrt(d)
            abs_q = (band_start + q_pos)[:, None]
            abs_k = (band_start + j * kv_chunk
                     + torch.arange(kv_chunk, device=dev))[None, :]
            ok = (_mask_value(abs_q, abs_k, causal, window)
                  & (abs_k >= 0) & (abs_k < sk))
            scores = torch.where(ok[None, None], scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qc.dtype), vc).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1)


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


def attend_decode_int8(q, k_q, k_s, v_q, v_s, kv_len_mask=None, *,
                       reduce=None) -> torch.Tensor:
    """Fully-integer decode attention over an int8 KV cache (KIVI-style):
    q and the v-scale-folded probabilities are quantized too, so both
    contractions are int8 x int8 -> int32.  ``reduce(op, x)`` (op "max"
    or "sum") completes each reduction over the key axis across the
    ranks of a sequence-split cache (:func:`_attend_seq_shard`): the
    score max, the denominator, the probability scale and the int32
    products."""
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
    if reduce is None:
        def reduce(op, x):
            return x
    m = reduce("max", scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m)
    l = reduce("sum", p.sum(dim=-1))
    p_fold = p * v_s.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    p_scale = torch.clamp_min(reduce("max", p_fold.amax(dim=-1)),
                              1e-8) / 127.0
    pq = torch.clamp(torch.round(p_fold / p_scale[..., None]), 0, 127).to(
        torch.int8)
    o_int = reduce("sum", _int_dot(pq.reshape(b, kvh, sq * groups, -1),
                                   v_q.permute(0, 2, 1, 3))).reshape(
        b, kvh, sq, groups, d)
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
                        impl: str = "reference", kv_splits: int | None = None,
                        split_pages: int | None = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.  q [B, 1, H, D]; pages
    [NB, BS, KVH, D] tensors or int8 QTensors; block_tables [B, W];
    n_valid [B] live positions per row.  ``kv_splits`` / ``split_pages``
    reach the fused kernel (``paged_ops.paged_attention``)."""
    if impl == "fused":
        from repro_torch.kernels.paged_attention import ops as paged_ops
        return paged_ops.paged_attention(q, k_pages, v_pages, block_tables,
                                         n_valid, kv_splits=kv_splits,
                                         split_pages=split_pages)
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


def _attend_dense_cache(q, k, v, kv_cache: dict, *, causal: bool = True,
                        window=None, chunked_threshold: int = 2048
                        ) -> torch.Tensor:
    """The dense (non-paged) KV cache: ``kv_cache`` holds ``k``/``v``
    ``[B, S_max, KVH, D]`` (int8 codes with bf16 ``k_scale``/``v_scale``
    ``[B, S_max, KVH]`` for an int8 cache) and ``len``, a 0-d int32 tensor
    shared by the batch.  A prefill (S > 1) attends the in-hand K/V
    (the cache holds nothing yet; ``attend_chunked`` past
    ``chunked_threshold``) and writes them at ``len``; a decode writes one
    slot and attends the cache up to it.

    With a sliding ``window`` and a cache no longer than it, the cache is
    a ring: a prefill writes its last ``min(S, S_max)`` positions at
    ``position % S_max``, a decode writes at ``len % S_max`` and attends
    the ``min(len + 1, S_max)`` live slots (keys are stored post-RoPE, so
    the slot order does not matter).  A longer windowed cache takes the
    band mask instead.  Writes and the ``len`` advance happen in place,
    on the device.  A :class:`spmd.SeqShard` cache holds this rank's
    positions of a sequence split over 'model' (:func:`_attend_seq_shard`).
    """
    if isinstance(kv_cache, spmd.SeqShard):
        return _attend_seq_shard(q, k, v, kv_cache, window=window)
    s = q.shape[1]
    dev = q.device
    length = kv_cache["len"]
    s_cache = kv_cache["k"].shape[1]
    ring = window is not None and s_cache <= window
    int8 = "k_scale" in kv_cache
    if not ring:
        idx = length.long() + torch.arange(s, device=dev)
    elif s > 1:
        idx = torch.arange(s - min(s, s_cache), s, device=dev) % s_cache
    else:
        idx = (length.long() % s_cache).reshape(1)
    tail = slice(s - idx.numel(), s)
    for name, x in (("k", k[:, tail]), ("v", v[:, tail])):
        if int8:
            codes, scale = quantize_kv(x)
            kv_cache[name].index_copy_(1, idx, codes)
            kv_cache[f"{name}_scale"].index_copy_(
                1, idx, scale.to(kv_cache[f"{name}_scale"].dtype))
        else:
            kv_cache[name].index_copy_(1, idx, x.to(kv_cache[name].dtype))
    if s > 1:
        if s <= chunked_threshold:
            out = attend_full(q, k, v, causal=causal, window=window)
        else:
            out = attend_chunked(q, k, v, causal=causal, window=window)
    else:
        slots = torch.arange(s_cache, device=dev)
        if ring:
            mask = (slots < torch.clamp_max(length + s, s_cache))[None]
        else:
            mask = (slots < length + s)[None]
            if window is not None:
                mask = mask & (slots > length + s - 1 - window)[None]
        if int8:
            out = attend_decode_int8(q, kv_cache["k"], kv_cache["k_scale"],
                                     kv_cache["v"], kv_cache["v_scale"],
                                     mask)
        else:
            out = attend_decode(q, kv_cache["k"], kv_cache["v"], mask)
    length.add_(s)
    return out


def _owner_write(t: torch.Tensor, idx: torch.Tensor, own: torch.Tensor,
                 x: torch.Tensor) -> None:
    """``t[:, idx] = x`` where ``own`` (a 0-d bool) holds, else unchanged:
    index arithmetic, no host read."""
    old = t.index_select(1, idx)
    t.index_copy_(1, idx, torch.where(own, x.to(t.dtype), old))


def _attend_seq_shard(q, k, v, kv_cache, *, window=None) -> torch.Tensor:
    """One decode step over a :class:`spmd.SeqShard` dense cache: every
    rank computes the new token's k/v (activations are replicated over
    'model'); the rank owning its position (its ring slot under a
    window) writes it at ``position - offset``; attention combines the
    shards (:func:`_attend_shards`; an int8 cache by
    :func:`attend_decode_int8`'s own reductions) under
    :func:`_attend_dense_cache`'s masks, on the global slot indices."""
    s = q.shape[1]
    if s != 1:
        raise ValueError(f"a sequence-split cache serves decode steps "
                         f"(S == 1), got S={s}")
    dev = q.device
    length = kv_cache["len"]
    mesh = kv_cache.mesh
    s_local = kv_cache["k"].shape[1]
    s_cache = s_local * mesh.shape[tuple(mesh.mesh_dim_names)
                                   .index("model")]
    ring = window is not None and s_cache <= window
    slot = length.long() % s_cache if ring else length.long()
    local = slot - kv_cache.offset
    own = (local >= 0) & (local < s_local)
    idx = torch.clamp(local, 0, s_local - 1).reshape(1)
    int8 = "k_scale" in kv_cache
    for name, x in (("k", k), ("v", v)):
        if int8:
            codes, scale = quantize_kv(x)
            _owner_write(kv_cache[name], idx, own, codes)
            _owner_write(kv_cache[f"{name}_scale"], idx, own, scale)
        else:
            _owner_write(kv_cache[name], idx, own, x)
    slots = kv_cache.offset + torch.arange(s_local, device=dev)
    if ring:
        mask = (slots < torch.clamp_max(length + s, s_cache))[None]
    else:
        mask = (slots < length + s)[None]
        if window is not None:
            mask = mask & (slots > length + s - 1 - window)[None]
    if int8:
        out = attend_decode_int8(
            q, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"],
            kv_cache["v_scale"], mask.expand(q.shape[0], s_local),
            reduce=collectives._reducer(mesh.get_group("model")))
    else:
        out = _attend_shards(q, kv_cache["k"], kv_cache["v"], mask, mesh)
    length.add_(s)
    return out


def _attend_shards(q, k, v, valid, mesh) -> torch.Tensor:
    """Decode attention ([B, 1, H, D]) over this rank's shards k/v
    ``[B, S/m, KVH, D]`` of a sequence split over 'model'; ``valid``
    ``[B or 1, S/m]`` marks the live positions.  Each rank's partials
    are merged by the flash-decode combine of
    ``collectives.seq_parallel_decode_attention``."""
    b, _, h, d = q.shape
    m, l, o = collectives._partial_decode(q, k, v,
                                          valid.expand(b, k.shape[1]))
    out = collectives._combine(m, l, o, mesh.get_group("model"))
    return out.reshape(b, 1, h, d).to(q.dtype)


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


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, *, device="cuda") -> dict:
    """A zero dense KV cache in the JAX package's layout: ``k``/``v``
    [B, max_len, KVH, D], a 0-d int32 ``len``, and bf16 ``k_scale`` /
    ``v_scale`` [B, max_len, KVH] when ``dtype`` is int8."""
    dev = device_lib.resolve(device)
    shape = (batch, max_len, n_kv_heads, head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev),
         "len": torch.zeros((), dtype=torch.int32, device=dev)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                  device=dev)
    return c


def attention(p: dict, x: torch.Tensor, cfg, *, positions=None,
              causal: bool = True, kv_cache: dict | None = None,
              xattn_kv: torch.Tensor | None = None,
              xattn_cache: dict | None = None, mode=None,
              chunked_threshold: int = 2048):
    """Attention layer.  Returns (output [B, S, d_model], updated cache or
    None).

    Self-attention (the default) rotates q and k at ``positions``: [B, S],
    or [3, B, S] t/h/w ids under M-RoPE (``cfg.mrope_sections``); None
    means ``arange(S)`` past the cache's length, the same on every M-RoPE
    axis.  ``causal=False`` is the encoder's bidirectional attention.
    ``kv_cache`` is None (full-sequence forward), a dense cache {k, v,
    len[, k_scale, v_scale]} (``_attend_dense_cache``) or a paged-pool
    view {k, v, block_tables, lens[, write_mask, chunk_len, pf_has_past]}:
    S == 1 decodes one token per row, S > 1 prefills (a whole prompt into
    a dense cache, a chunk into the pool).

    Cross-attention takes no rotary embedding and no mask: ``xattn_kv``
    (the encoder output [B, S_enc, d_model]) projects k/v here, in the
    full-sequence forward; ``xattn_cache`` ({k, v} [B, S_enc, KVH, D],
    projected once by ``transformer.precompute_cross_kv``) serves prefill
    and decode.  Under int8 residency q/k/v share one conversion of x in
    self-attention only: cross-attention's q and k/v read different
    sources."""
    mode = mode or cfg.linear_mode
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    window = cfg.sliding_window
    cross = xattn_kv is not None or xattn_cache is not None

    x_in = x
    if backend_lib.residency_enabled(mode) and not cross:
        x_in = backend_lib.shared_quant((p["q"], p["k"], p["v"]), x)

    q = layers.dense(p["q"], x_in, mode, dtype=dt,
                     path="attn/q").reshape(b, s, cfg.n_heads, hd)
    q = constrain(q, {0: "batch", 2: "model"})

    def out_proj(o):
        return layers.dense(p["o"], o.reshape(b, s, cfg.n_heads * hd), mode,
                            path="attn/o").to(dt)

    if xattn_cache is not None:
        kx, vx = xattn_cache["k"], xattn_cache["v"]
        if isinstance(xattn_cache, spmd.SeqShard):
            if s != 1:
                raise ValueError("a frame-split cross K/V cache serves "
                                 f"decode steps (S == 1), got S={s}")
            out = _attend_shards(q, kx, vx, torch.ones(
                (1, kx.shape[1]), dtype=torch.bool, device=x.device),
                xattn_cache.mesh)
        elif max(s, kx.shape[1]) <= chunked_threshold:
            out = attend_decode(q, kx, vx)
        else:
            out = attend_chunked(q, kx, vx, causal=False,
                                 q_chunk=min(512, s))
        return out_proj(out), None

    kv_src = x_in if xattn_kv is None else xattn_kv
    sk = kv_src.shape[1]
    k = layers.dense(p["k"], kv_src, mode, dtype=dt,
                     path="attn/k").reshape(b, sk, cfg.n_kv_heads, hd)
    v = layers.dense(p["v"], kv_src, mode, dtype=dt,
                     path="attn/v").reshape(b, sk, cfg.n_kv_heads, hd)
    k = constrain(k, {0: "batch", 2: "model"})
    v = constrain(v, {0: "batch", 2: "model"})
    if "q_norm" in p:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)

    paged = kv_cache is not None and "block_tables" in kv_cache
    if paged:
        if xattn_kv is not None:
            raise ValueError("paged KV caches serve self-attention only")
        if window is not None:
            raise ValueError("paged KV caches do not model sliding windows "
                             "(no ring blocks)")
        if cfg.mrope_sections is not None:
            raise ValueError("paged KV caches are single-axis-RoPE only "
                             "(per-row lens positions have no t/h/w M-RoPE "
                             "layout)")

    if xattn_kv is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
            if kv_cache is not None:
                positions = positions + (kv_cache["lens"][:, None] if paged
                                         else kv_cache["len"])
            if cfg.mrope_sections is not None:
                positions = positions[None].expand(3, 1, s)
        ang = layers.rope_angles(positions, hd, cfg.rope_theta,
                                 cfg.mrope_sections)
        q = layers.apply_rope(q, ang)
        k = layers.apply_rope(k, ang)

    if kv_cache is None:
        q_chunk = 512
        if xattn_kv is not None:
            causal, window, q_chunk = False, None, min(512, s)
        if max(s, sk) <= chunked_threshold:
            out = attend_full(q, k, v, causal=causal, window=window)
        else:
            out = attend_chunked(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk)
        return out_proj(out), None

    if not paged:
        out = _attend_dense_cache(q, k, v, kv_cache, causal=causal,
                                  window=window,
                                  chunked_threshold=chunked_threshold)
        return out_proj(out), kv_cache
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
                              impl=impl,
                              split_pages=kv_cache.get("split_pages"))
    return out_proj(out), {"k": k_pages, "v": v_pages}
