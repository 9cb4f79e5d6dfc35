"""Shape heuristics shared by the serve loop and the kernel wrappers (port
of the bucketing and split/chunk heuristics of ``repro/kernels/autotune.py``).

The TPU package's ``(bm, bn, bk)`` block table is a choice for the MXU and
is not ported: the CUDA int8 GEMM kernels take their path, tile and
split from :func:`cim_matmul_config`.  What carries over is power-of-two
bucketing (tight table widths, few distinct shapes) and the deterministic
split-count / chunk-length heuristics.  No measured table exists for the
card yet, so ``choose_*`` return the heuristic.
"""
from __future__ import annotations

from typing import NamedTuple


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


def heuristic_paged_splits_cuda(batch: int, kvh: int, width: int,
                                sm_count: int) -> int:
    """Split count for the CUDA decode kernel: the smallest power of two
    that gives (batch x kv_heads x splits) >= 2 blocks per SM, halved
    while a split would own no page of the table (splits take
    ceil(width / splits) pages each).  The serve loop passes pow2-bucketed
    live widths, where the cap is the width itself."""
    par = max(1, batch * kvh)
    s = next_pow2(max(1, -(-2 * sm_count // par)))
    while s > 1 and (s - 1) * -(-width // s) >= width:
        s //= 2
    return s


def paged_split_pages(batch: int, kvh: int, max_width: int,
                      sm_count: int) -> int:
    """Pages per split that an engine fixes for its decode kernel: the
    pages each of :func:`heuristic_paged_splits_cuda`'s splits owns at
    the engine's widest table ``max_width``.

    A split then owns the same pages of a row at every narrower width
    (the kernel takes ``ceil(width / pps)`` splits, none more than the
    heuristic picks at ``max_width``), so a row's partials and its merged
    output are the same bits whatever widths the rest of the batch sets:
    a request decodes alike beside any neighbours, which page-out
    preemption and snapshot restore on the card rely on."""
    width = max(1, max_width)
    return -(-width // heuristic_paged_splits_cuda(batch, kvh, width,
                                                   sm_count))


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


class MatmulConfig(NamedTuple):
    """How the int8 GEMM kernels (K1 ``cim_matmul``, K4 ``bitplane_matmul``)
    run one ``[M, K] x [K, N]`` product on the card.

    ``path`` is ``"wgmma"`` (``csrc/int8_wgmma.cuh``: ``nt`` row tiles of 64
    weight columns, ``bt`` tokens, ``splits`` blocks of one cluster along K)
    or ``"masked"`` (``csrc/int8_tiles.cuh``'s byte-masked 64 x 64 tiles,
    ``nt = bt = 0``, one split)."""
    path: str
    nt: int
    bt: int
    splits: int


GEMM_BK = 64            # K bytes per ring stage (csrc/int8_wgmma.cuh BK)
GEMM_MAX_SPLITS = 16    # blocks per cluster (16 needs the non-portable opt-in)


def _no_empty_split(steps: int, splits: int) -> bool:
    """Splits take ceil(steps / splits) K steps each; the last must get
    at least one."""
    return (splits - 1) * -(-steps // splits) < steps


def cim_matmul_config(m: int, n: int, k: int, sm_count: int) -> MatmulConfig:
    """Tile, split and path of the int8 GEMM kernels, from the shape alone.

    - Rows whose byte length is not a multiple of 16 (K or N; VGG-8's
      conv1 K = 27, the head's N = 10) cannot be copied 16 bytes at a
      time: the masked path.
    - Decode (M <= 16) is bound by weight bytes: 8 or 16 tokens (wgmma's
      N, no 64-row padding) and two row tiles (128 columns: 128-byte
      weight rows stream faster than 64-byte ones), or one (64 columns)
      where 128-column tiles could not make a wave even split 16 ways
      (k/v).  Larger M takes two row tiles (all of VGG-8 conv2's N, so A
      is read once) and 64 or 128 tokens.
    - Split K over a cluster, in powers of two up to 16, until the blocks
      make one wave (``sm_count``), never leaving a split without a K
      step.
    """
    if k % 16 or n % 16:
        return MatmulConfig("masked", 0, 0, 1)
    if m <= 16:
        bt = 8 if m <= 8 else 16
        nt = 2 if -(-n // 128) * GEMM_MAX_SPLITS >= sm_count else 1
    else:
        nt, bt = 2, (64 if m <= 64 else 128)
    tiles = -(-n // (64 * nt)) * -(-m // bt)
    steps = -(-k // GEMM_BK)
    splits = 1
    while (tiles * splits < sm_count and splits * 2 <= GEMM_MAX_SPLITS
           and _no_empty_split(steps, splits * 2)):
        splits *= 2
    return MatmulConfig("wgmma", nt, bt, splits)
