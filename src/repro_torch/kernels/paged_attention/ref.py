"""Oracles for the paged-attention kernels (port of
``repro/kernels/paged_attention/ref.py``): the serve path's
gather-then-attend implementation in ``models.attention``.

* fp pools   -- fp-rounding-level agreement with the kernels (the online
  softmax reorders the same f32 operations).
* int8 pools -- the kernels dequantize pages and keep q and the
  probabilities in f32, while the gather reference runs a fully-integer
  pipeline (q and p quantized too), so parity with it is loose;
  :func:`dequant_attention_ref` (fp attention over the dequantized pages)
  is the tight oracle.
"""
from __future__ import annotations


def paged_attention_ref(q, k_pages, v_pages, block_tables, n_valid):
    """Gather-then-attend decode reference."""
    from repro_torch.models import attention
    return attention.attend_decode_paged(q, k_pages, v_pages, block_tables,
                                         n_valid, impl="reference")


def paged_prefill_ref(q, k_new, v_new, k_pages, v_pages, block_tables, pos,
                      n_tok, write_mask=None):
    """Gather-then-attend chunked-prefill reference (pages written in
    place on the quantize_kv grid)."""
    from repro_torch.models import attention
    return attention.attend_prefill_paged(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, pos, n_tok,
                                          write_mask, impl="reference")


def dequant_attention_ref(q, k_pages, v_pages, block_tables, n_valid):
    """fp attention over the dequantized pages: the tight oracle for the
    int8 decode kernel."""
    from repro_torch.core import quant
    from repro_torch.models import attention
    if isinstance(k_pages, quant.QTensor):
        k_pages = k_pages.dequant()
        v_pages = v_pages.dequant()
    return attention.attend_decode_paged(q, k_pages, v_pages, block_tables,
                                         n_valid, impl="reference")
