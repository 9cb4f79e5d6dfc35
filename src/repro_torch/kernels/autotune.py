"""Shape heuristics shared by the serve loop and the kernel wrappers (port
of the bucketing and split/chunk heuristics of ``repro/kernels/autotune.py``).

The TPU package's ``(bm, bn, bk)`` block table is a choice for the MXU and
is not ported: the CUDA matmul kernel picks its own tile.  What carries
over is power-of-two bucketing (tight table widths, few distinct shapes)
and the deterministic split-count / chunk-length heuristics.  No measured
table exists for the card yet, so ``choose_*`` return the heuristic.
"""
from __future__ import annotations


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def m_bucket(m: int) -> int:
    """Power-of-two M bucket (>= 8)."""
    return max(8, next_pow2(m))


def heuristic_paged_splits(batch: int, kvh: int, width: int,
                           block_size: int, dtype=None) -> int:
    """Split count from the decode shape alone: (batch x kv_heads)
    programs already run in parallel; split only to reach ~8 programs,
    never below one page per program."""
    del block_size, dtype
    par = max(1, batch * kvh)
    want = max(1, -(-8 // par))
    return min(width, next_pow2(want))


def choose_paged_splits(batch: int, kvh: int, width: int, block_size: int,
                        dtype=None, *, head_dim: int = 0,
                        groups: int = 1) -> int:
    del head_dim, groups
    return heuristic_paged_splits(batch, kvh, width, block_size, dtype)


def heuristic_prefill_chunk(block_size: int) -> int:
    """~64 tokens per chunk, always a block_size multiple."""
    return block_size * max(1, 64 // block_size)


def choose_prefill_chunk(batch: int, kvh: int, block_size: int,
                         dtype=None, *, head_dim: int = 0,
                         groups: int = 1) -> int:
    del batch, kvh, dtype, head_dim, groups
    return heuristic_prefill_chunk(block_size)
