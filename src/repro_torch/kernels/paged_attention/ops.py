"""Public wrappers of the paged decode and chunked paged prefill kernels
(port of ``repro/kernels/paged_attention/ops.py``).

``paged_attention`` is what the model layer calls for decode behind
``DeploymentPlan.paged_attn`` and ``paged_prefill`` for prefill chunks.
Both accept the pool's native pages -- fp tensors ``[NB, BS, KVH, D]`` or
int8 :class:`~repro_torch.core.quant.QTensor` pages (scale
``[NB, BS, KVH, 1]``) -- and run the CUDA kernel (``csrc/paged_attention.cu``,
``csrc/flash_prefill.cu``) on CUDA tensors or its plain PyTorch twin on CPU
tensors.  A CUDA tensor never takes the plain path.  The decode
partials' combine is ``merge_splits`` on the CPU and its one-launch CUDA
form ``merge_splits_kernel`` on the card.

Unlike the JAX package, the pool is updated in place: ``paged_prefill``
writes the chunk's K/V into the given pages and returns the same page
objects.  Masked rows (``write_mask`` 0) and dead tail pages are skipped,
so -- where the JAX version sends them to null block 0 -- block 0 keeps
its bytes here; its contents are garbage by contract either way.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import quant
from repro_torch.device import sm_count
from repro_torch.kernels import autotune, build

NEG_INF = -1e30

# Launch counts of the CUDA kernels (plain integers).
decode_launches = 0
prefill_launches = 0
merge_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def merge_splits(acc, m, l):
    """Logsumexp-combine split-KV partials over the split axis (axis 2).

    acc [B,KVH,S,G,D], m/l [B,KVH,S,G,1] -> [B,KVH,G,D].  Dead splits carry
    (acc=0, m=NEG_INF, l=0); a row with no live positions returns zeros."""
    m_g = m.amax(dim=2, keepdim=True)
    alpha = torch.exp(m - m_g)
    l_g = (l * alpha).sum(dim=2)
    acc_g = (acc * alpha).sum(dim=2)
    return acc_g / torch.clamp_min(l_g, 1e-30)


def _split_pages(pages):
    """QTensor pages -> (codes, [NB,BS,KVH] scales); fp -> (pages, None)."""
    if isinstance(pages, quant.QTensor):
        return pages.q, pages.scale[..., 0]
    return pages, None


# ---------------------------------------------------------------------------
# Decode: split-KV flash decoding
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_pages, v_pages, k_scale, v_scale,
                          block_tables, n_valid, *, kv_splits: int = 1):
    """The decode kernel's function in plain PyTorch: split-KV partials
    ``(acc [B,KVH,S,G,D], m [B,KVH,S,G,1], l [B,KVH,S,G,1])``.

    q [B,KVH,G,D]; pages [NB,BS,KVH,D] (+ [NB,BS,KVH] bf16 scales for
    int8); block_tables [B,W]; n_valid [B].  Gathers the W referenced
    pages and computes each split's two-pass softmax partials."""
    b, kvh, g, d = q.shape
    bs = k_pages.shape[1]
    w = block_tables.shape[1]
    ns = max(1, min(kv_splits, w))
    pps = -(-w // ns)
    pad = ns * pps - w
    bt = block_tables.long()

    def gather(pages, scale):
        gp = pages[bt].to(torch.float32)               # [B, W, BS, KVH, D]
        if scale is not None:
            gp = gp * scale[bt].to(torch.float32)[..., None]
        if pad:
            gp = torch.nn.functional.pad(gp, (0, 0, 0, 0, 0, 0, 0, pad))
        return gp.reshape(b, ns, pps * bs, kvh, d)

    kg = gather(k_pages, k_scale)
    vg = gather(v_pages, v_scale)
    srs = torch.einsum("bkgd,bsnkd->bksgn", q.to(torch.float32), kg) \
        / math.sqrt(d)                                 # [B,KVH,ns,G,pps*BS]
    dev = q.device
    pos = (torch.arange(ns, device=dev)[:, None] * pps * bs
           + torch.arange(pps * bs, device=dev)[None, :])
    valid = (pos[None] < n_valid.to(dev)[:, None, None]) \
        & (pos[None] < w * bs)                         # [B, ns, pps*BS]
    valid = valid[:, None, :, None, :]
    srs = torch.where(valid, srs, NEG_INF)
    m = srs.amax(dim=-1, keepdim=True)
    prob = torch.where(valid, torch.exp(srs - m), 0.0)
    l = prob.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bksgn,bsnkd->bksgd", prob, vg)
    return acc, m, l


def _check_pages(k_pages, v_pages, k_scale, v_scale, dev):
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be f32/bf16/int8, got {k_pages.dtype}")
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("pages must be [NB, BS, KVH, D], K and V alike")
    int8 = k_pages.dtype == torch.int8
    if (k_scale is not None) != int8 or (v_scale is not None) != int8:
        raise ValueError("int8 pages need scales, fp pages take none")
    tensors = [k_pages, v_pages]
    if int8:
        for s in (k_scale, v_scale):
            if s.dtype != torch.bfloat16 or s.shape != k_pages.shape[:3]:
                raise ValueError("page scales must be bf16 [NB, BS, KVH]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("pages and scales must be contiguous tensors "
                             "on the kernel's device")


def _check_index(t, shape, dev, name):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 {tuple(shape)} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _check_aligned(*tensors):
    """The kernels stage rows with 16-byte cp.async copies."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernels' tensors must start on a "
                             "16-byte boundary")


def _aligned(t):
    """``t`` contiguous and on a 16-byte boundary (copied if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.cache
def _decode_fn():
    fn = build.library("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _merge_fn():
    fn = build.library("paged_attention").merge_splits_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def merge_splits_kernel(acc, m, l):
    """:func:`merge_splits` as one CUDA launch (same arguments and
    result)."""
    global merge_launches
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"merge_splits_kernel needs CUDA tensors, got "
                         f"{dev}")
    b, kvh, ns, g, d = acc.shape
    for t, shape in ((acc, (b, kvh, ns, g, d)), (m, (b, kvh, ns, g, 1)),
                     (l, (b, kvh, ns, g, 1))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError("partials must be contiguous f32 acc [B, KVH, "
                             "S, G, D] and m, l [B, KVH, S, G, 1]")
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = _merge_fn()(acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                     out.data_ptr(), b * kvh, ns, g, d,
                     torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "merge_splits")
    merge_launches += 1
    return out


def paged_attention_kernel(q, k_pages, v_pages, k_scale, v_scale,
                           block_tables, n_valid, *, kv_splits: int = 1):
    """Launch the decode kernel; same arguments and partials as
    :func:`paged_attention_plain`.  Raises on what the kernel does not
    take."""
    global decode_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_kernel needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 4 \
            or not q.is_contiguous():
        raise ValueError("q must be a contiguous f32/bf16 [B, KVH, G, D]")
    b, kvh, g, d = q.shape
    _check_pages(k_pages, v_pages, k_scale, v_scale, dev)
    nb, bs, kvh2, d2 = k_pages.shape
    if (kvh2, d2) != (kvh, d):
        raise ValueError(f"q heads/dim {(kvh, d)} != pages {(kvh2, d2)}")
    if d not in (32, 64, 128, 256):
        raise ValueError(f"kernel takes D in {{32, 64, 128, 256}}, got {d}")
    _check_aligned(k_pages, v_pages)
    w = block_tables.shape[1]
    _check_index(block_tables, (b, w), dev, "block_tables")
    _check_index(n_valid, (b,), dev, "n_valid")
    ns = max(1, min(kv_splits, w))
    acc = torch.empty((b, kvh, ns, g, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, kvh, ns, g, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, kvh, ns, g, 1), dtype=torch.float32, device=dev)
    if b == 0:
        return acc, m, l
    rc = _decode_fn()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _DTYPE_CODE[k_pages.dtype], _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), n_valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kvh, g, d, bs, w, ns,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_attention")
    decode_launches += 1
    return acc, m, l


def paged_attention(q, k_pages, v_pages, block_tables, n_valid, *,
                    kv_splits: int | None = None):
    """Fused paged decode attention: q [B, 1, H, D] -> [B, 1, H, D].

    ``kv_splits`` defaults to the heuristic for this shape: on CUDA the
    card's (enough splits to give every SM two blocks), on the CPU the JAX
    package's.  ``n_valid`` is effectively clamped to the table capacity
    ``W * BS``."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("paged flash decoding serves single-token queries")
    k_q, k_s = _split_pages(k_pages)
    v_q, v_s = _split_pages(v_pages)
    bs, kvh = k_q.shape[1], k_q.shape[2]
    g = h // kvh
    width = block_tables.shape[1]
    if kv_splits is None and q.device.type == "cuda":
        kv_splits = autotune.heuristic_paged_splits_cuda(
            b, kvh, width, sm_count(q.device))
    elif kv_splits is None:
        kv_splits = autotune.choose_paged_splits(
            b, kvh, width, bs, k_q.dtype, head_dim=d, groups=g)
    qr = q.reshape(b, kvh, g, d)
    args = (k_q, v_q, k_s, v_s, block_tables.to(torch.int32),
            n_valid.to(torch.int32))
    if q.device.type == "cpu":
        out = merge_splits(*paged_attention_plain(qr, *args,
                                                  kv_splits=kv_splits))
    else:
        out = merge_splits_kernel(*paged_attention_kernel(
            qr.contiguous(), *args, kv_splits=kv_splits))
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Prefill: causal chunk attention + paged KV writes
# ---------------------------------------------------------------------------

def write_chunk_pages(pages, new, block_tables, pos, n_tok, write_mask):
    """Write one chunk's K or V ([B, C, KVH, D] fp) into its pool pages,
    in place: the ``quantize_kv`` grid for int8 QTensor pools, a cast for
    fp pools.  Chunk starts are page-aligned, so chunk page j of row b
    lands in table slot ``pos[b] // BS + j``; masked rows, ragged dead-tail
    pages and slots past the table are skipped."""
    codes_t = pages.q if isinstance(pages, quant.QTensor) else pages
    bs = codes_t.shape[1]
    b, c = new.shape[:2]
    if c % bs:
        raise ValueError(f"chunk {c} must be a block_size {bs} multiple")
    cp = c // bs
    w = block_tables.shape[1]
    dev = new.device
    j = torch.arange(cp, device=dev)
    slots = pos.to(dev).long()[:, None] // bs + j[None, :]      # [B, CP]
    live = (j[None, :] * bs < n_tok.to(dev)[:, None]) & (slots < w)
    if write_mask is not None:
        live = live & write_mask.to(dev).bool()[:, None]
    idx = torch.gather(block_tables.to(dev).long(), 1,
                       torch.clamp_max(slots, w - 1))[live]
    chunk = new.reshape(b, cp, bs, *new.shape[2:])[live]  # [n, BS, KVH, D]
    if isinstance(pages, quant.QTensor):
        from repro_torch.models.attention import quantize_kv
        codes, scale = quantize_kv(chunk)
        pages.q[idx] = codes
        pages.scale[idx] = scale[..., None]
    else:
        pages[idx] = chunk.to(pages.dtype)
    return pages


def flash_prefill_plain(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale,
                        block_tables, pos, n_tok, write_mask, *,
                        has_past: bool = True):
    """The prefill kernel's function in plain PyTorch (the counterpart of
    the JAX package's ``flash_prefill_jnp`` + ``write_chunk_pages``):
    returns the attention output [B, KVH, C*G, D] and writes the chunk's
    K/V into the pages (codes and scales for int8 pools) in place.

    q [B,KVH,C*G,D] chunk-major (row = c*G + g); k_new/v_new [B,C,KVH,D]
    fp; pages [NB,BS,KVH,D] (+ [NB,BS,KVH] scales for int8); block_tables
    [B,W]; pos [B] past tokens; n_tok [B] valid chunk tokens; write_mask
    [B] int32.  Every chunk query attends all past positions < pos plus
    the causal, ragged-tail-masked prefix of the in-hand chunk.  Masked
    rows still attend (their output is discarded by the caller) but write
    nothing.  ``has_past=False`` (every pos is 0) skips the past gather."""
    b, kvh, cg, d = q.shape
    c = k_new.shape[1]
    g = cg // c
    bs = k_pages.shape[1]
    w = block_tables.shape[1]
    sp = w * bs if has_past else 0
    dev = q.device
    bt = block_tables.long()

    def gather(pages, scale):
        gp = pages[bt].to(torch.float32)               # [B, W, BS, KVH, D]
        if scale is not None:
            gp = gp * scale[bt].to(torch.float32)[..., None]
        return gp.reshape(b, sp, kvh, d)

    if has_past:
        k_all = torch.cat([gather(k_pages, k_scale),
                           k_new.to(torch.float32)], 1)
        v_all = torch.cat([gather(v_pages, v_scale),
                           v_new.to(torch.float32)], 1)
    else:
        k_all = k_new.to(torch.float32)
        v_all = v_new.to(torch.float32)
    qc = q.reshape(b, kvh, c, g, d).to(torch.float32)
    srs = torch.einsum("bkcgd,bskd->bkcgs", qc, k_all) \
        / math.sqrt(d)                                 # [B,KVH,C,G,Sp+C]
    kp = torch.arange(sp + c, device=dev)
    pos = pos.to(dev)
    n_tok = n_tok.to(dev)
    past_ok = (kp[None, :] < pos[:, None]) & (kp < sp)[None, :]
    ci = torch.arange(c, device=dev)
    self_ok = ((kp[None, None, :] >= sp)
               & (kp[None, None, :] - sp <= ci[None, :, None])
               & ((kp[None, :] - sp < n_tok[:, None])[:, None, :]))
    valid = (past_ok[:, None, :] | self_ok)[:, None, :, None, :]
    srs = torch.where(valid, srs, NEG_INF)
    m = srs.amax(dim=-1, keepdim=True)
    prob = torch.where(valid, torch.exp(srs - m), 0.0)
    l = prob.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkcgs,bskd->bkcgd", prob, v_all)
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    wm = write_mask.bool()
    for pages, scale, new in ((k_pages, k_scale, k_new),
                              (v_pages, v_scale, v_new)):
        pool = pages if scale is None else quant.QTensor(pages, scale[..., None])
        write_chunk_pages(pool, new, block_tables, pos, n_tok, wm)
    return out.reshape(b, kvh, cg, d)


@functools.cache
def _prefill_fn():
    fn = build.library("flash_prefill").flash_prefill_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_prefill_kernel(q, k_new, v_new, k_pages, v_pages, k_scale,
                         v_scale, block_tables, pos, n_tok, write_mask):
    """Launch the prefill kernel; same arguments, result and in-place page
    writes as :func:`flash_prefill_plain`."""
    global prefill_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_prefill_kernel needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 4:
        raise ValueError("q must be f32/bf16 [B, KVH, C*G, D]")
    b, kvh, cg, d = q.shape
    c = k_new.shape[1]
    for t in (q, k_new, v_new):
        if t.dtype != q.dtype or t.device != dev or not t.is_contiguous():
            raise ValueError("q, k_new, v_new must be contiguous tensors of "
                             "one dtype on the kernel's device")
    if k_new.shape != (b, c, kvh, d) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be [B, C, KVH, D] = "
                         f"{(b, c, kvh, d)}, got {tuple(k_new.shape)}")
    _check_pages(k_pages, v_pages, k_scale, v_scale, dev)
    bs = k_pages.shape[1]
    if tuple(k_pages.shape[2:]) != (kvh, d):
        raise ValueError("pages' heads/dim differ from q's")
    g = cg // c
    if cg != c * g or c % bs or d % 32 or d > 256:
        raise ValueError(f"kernel takes C a block_size multiple and D in "
                         f"{{32..256}} step 32 (C={c}, BS={bs}, D={d})")
    _check_aligned(q, k_new, v_new, k_pages, v_pages)
    w = block_tables.shape[1]
    _check_index(block_tables, (b, w), dev, "block_tables")
    for t, name in ((pos, "pos"), (n_tok, "n_tok"),
                    (write_mask, "write_mask")):
        _check_index(t, (b,), dev, name)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = _prefill_fn()(
        q.data_ptr(), _DTYPE_CODE[q.dtype], k_new.data_ptr(),
        v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _DTYPE_CODE[k_pages.dtype], _ptr(k_scale), _ptr(v_scale),
        block_tables.data_ptr(), pos.data_ptr(), n_tok.data_ptr(),
        write_mask.data_ptr(), out.data_ptr(), b, kvh, c, g, d, bs, w,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "flash_prefill")
    prefill_launches += 1
    return out


def paged_prefill(q, k_new, v_new, k_pages, v_pages, block_tables, pos,
                  n_tok, write_mask=None, *, has_past: bool = True):
    """Fused causal-chunk paged prefill: attention over (past pool pages +
    in-hand chunk) AND the chunk's K/V quantized and written into the pool.

    q [B,C,H,D]; k_new/v_new [B,C,KVH,D] fp post-RoPE; pages as in
    :func:`paged_attention`.  Returns ``(out [B,C,H,D], k_pages, v_pages)``
    with the pages updated in place.  ``has_past=False`` (every pos is 0)
    lets the plain version skip its past gather; the kernel needs no hint,
    it never walks past pages a row does not have."""
    b, c, h, d = q.shape
    k_q, k_s = _split_pages(k_pages)
    v_q, v_s = _split_pages(v_pages)
    kvh = k_q.shape[2]
    g = h // kvh
    dev = q.device
    wm = (torch.ones(b, dtype=torch.int32, device=dev) if write_mask is None
          else write_mask.to(device=dev, dtype=torch.int32))
    bt = block_tables.to(device=dev, dtype=torch.int32)
    pos = pos.to(device=dev, dtype=torch.int32)
    n_tok = n_tok.to(device=dev, dtype=torch.int32)
    qr = q.reshape(b, c, kvh, g, d).transpose(1, 2).reshape(b, kvh, c * g, d)
    if dev.type == "cpu":
        out = flash_prefill_plain(qr, k_new, v_new, k_q, v_q, k_s, v_s, bt,
                                  pos, n_tok, wm, has_past=has_past)
    else:
        out = flash_prefill_kernel(
            _aligned(qr), _aligned(k_new), _aligned(v_new), k_q, v_q, k_s,
            v_s, bt, pos, n_tok, wm)
    out = out.reshape(b, kvh, c, g, d).transpose(1, 2).reshape(b, c, h, d)
    return out.to(q.dtype), k_pages, v_pages
