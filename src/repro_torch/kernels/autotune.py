"""Kernel shape selection for the card: heuristics, measured tables and
their JSON files (port of the JAX package's autotuner,
``kernels/autotune.py``).

Three decisions are tuned, each by a table that a measurement (or a
loaded file) fills and that otherwise falls back to a deterministic
heuristic:

* **K1** (``cim_matmul``): the int8 GEMM's :class:`MatmulConfig` (path,
  row tiles, token tile, split-K) per ``(m_bucket(m), k, n, dtype)``.
  The TPU package's ``(bm, bn, bk)`` blocks are a choice for the MXU and
  mean nothing here, so K1's names map as follows:

  ====================  =======================================
  JAX package           this module
  ====================  =======================================
  ``heuristic_blocks``  :func:`cim_matmul_config` (exact ``m``)
  ``choose_blocks``     :func:`choose_config`
  ``record``            :func:`record` (a ``MatmulConfig``)
  ``candidate_blocks``  :func:`candidate_configs`
  ``measure``           :func:`measure`
  ====================  =======================================

  With nothing recorded, :func:`choose_config` is the heuristic of the
  exact ``m`` (not memoised per bucket: the heuristic's token tile and
  split differ inside one bucket); a recorded entry holds for the whole
  bucket.  K1 accumulates in int32 and applies its epilogue once, so
  every config gives the same bytes and a K1 table never changes a
  result.  K4 (``bitplane_matmul``) keeps the heuristic, as the JAX
  package tunes only the cim kernel.
* **K2** (paged decode): the split count per ``(m_bucket(batch), kvh,
  width, block_size, head_dim, groups, dtype)``.  The CPU arm reads
  :func:`choose_paged_splits` (JAX's heuristic, memoised); the card reads
  a measured entry where one exists, else
  :func:`heuristic_paged_splits_cuda`.  A serving engine fixes its pages
  per split once, from the entry at its own key
  (:func:`paged_split_pages`), so a row's bits never depend on its
  neighbours' widths.
* **K3** (chunked prefill): the chunk length per ``(m_bucket(batch), kvh,
  block_size, head_dim, groups, dtype)``, read by the engine at
  construction (:func:`choose_prefill_chunk`) on the CPU and the card.

``dtype`` in every key is JAX's ``jnp.dtype(x).name`` ("int8",
"float32", "bfloat16"), so the two packages load each other's files:
:func:`dump` writes the measured entries under JAX's field names
(``paged_entries``, ``prefill_entries``) and K1's under
``gemm_entries``, which the JAX package ignores; :func:`load` skips a JAX
file's TPU ``entries``.  ``REPRO_TORCH_AUTOTUNE_CACHE`` names
:func:`dump`'s default file (not the JAX package's variable, so neither
overwrites the other's table).
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterable, NamedTuple

import torch

from repro_torch import device as device_lib

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# The in-process decision tables.  K1's holds recorded configs only (its
# heuristic depends on the exact m); K2's and K3's also memoise the
# heuristic, as the JAX package's do.  The *_MEASURED sets are what
# `dump` writes, and what the card's decode reads from K2's table.
_TABLE: dict[tuple[int, int, int, str], "MatmulConfig"] = {}
_MEASURED: set[tuple[int, int, int, str]] = set()
_PAGED_TABLE: dict[tuple[int, int, int, int, int, int, str], int] = {}
_PAGED_MEASURED: set[tuple[int, int, int, int, int, int, str]] = set()
_PREFILL_TABLE: dict[tuple[int, int, int, int, int, str], int] = {}
_PREFILL_MEASURED: set[tuple[int, int, int, int, int, str]] = set()


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def m_bucket(m: int) -> int:
    """Power-of-two M bucket (>= 8)."""
    return max(8, next_pow2(m))


def dtype_name(dtype) -> str:
    """JAX's ``jnp.dtype(dtype).name`` of a torch dtype or a name:
    ``torch.int8`` -> "int8" (``str`` would give "torch.int8", which no
    JAX-written key matches)."""
    t = getattr(torch, str(dtype).removeprefix("torch."), None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return str(t).removeprefix("torch.")


def time_median_us(fn, iters: int = 3) -> float:
    """One warm call, then the median wall time of ``iters`` calls of the
    zero-argument ``fn``, in microseconds (the JAX package's method).
    Once CUDA is in use the card is synchronised before the clock starts
    and after each call, so the host's enqueue is counted as JAX's wall
    clock counts dispatch."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    fn()
    ts = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e6


# ---------------------------------------------------------------------------
# K1: the int8 GEMM's path, tile and split
# ---------------------------------------------------------------------------

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
# The (nt, bt) pairs csrc/cim_matmul.cu's wgmma entry point instantiates.
WGMMA_TILES = ((1, 8), (1, 16), (2, 8), (2, 16), (2, 64), (2, 128))
MASKED = MatmulConfig("masked", 0, 0, 1)


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
        return MASKED
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


def _valid_configs(k: int, n: int) -> list[MatmulConfig]:
    """Every config ``csrc/cim_matmul.cu`` launches for a K x N weight:
    the masked path where K or N is not a multiple of 16, else each
    instantiated (nt, bt) with a power-of-two split up to
    ``GEMM_MAX_SPLITS`` that leaves no split empty."""
    if k % 16 or n % 16:
        return [MASKED]
    steps = -(-k // GEMM_BK)
    splits = [1 << i for i in range(GEMM_MAX_SPLITS.bit_length())
              if _no_empty_split(steps, 1 << i)]
    return [MatmulConfig("wgmma", nt, bt, s) for nt, bt in WGMMA_TILES
            for s in splits]


def check_config(k: int, n: int, config) -> MatmulConfig:
    """``config`` as a :class:`MatmulConfig`; raises ``ValueError`` where
    the kernel does not take it for a K x N weight."""
    cfg = MatmulConfig(str(config[0]), *(int(c) for c in config[1:]))
    if cfg not in _valid_configs(k, n):
        raise ValueError(f"{cfg} is not a config the int8 GEMM kernel "
                         f"takes at K={k}, N={n}")
    return cfg


def candidate_configs(m: int, k: int, n: int,
                      sm_count: int) -> list[MatmulConfig]:
    """Every config the kernel takes for the shape, the heuristic's
    first (it is always one of them)."""
    h = cim_matmul_config(m, n, k, sm_count)
    return [h] + [c for c in _valid_configs(k, n) if c != h]


def _key(m: int, k: int, n: int, dtype) -> tuple[int, int, int, str]:
    return (m_bucket(m), int(k), int(n), dtype_name(dtype))


def choose_config(m: int, k: int, n: int, dtype,
                  sm_count: int) -> MatmulConfig:
    """K1's config for one product: a recorded (measured or loaded)
    entry for the M bucket, else :func:`cim_matmul_config` of the exact
    ``m``."""
    cfg = _TABLE.get(_key(m, k, n, dtype))
    return cfg if cfg is not None else cim_matmul_config(m, n, k, sm_count)


def record(m: int, k: int, n: int, dtype, config, *,
           measured: bool = True) -> None:
    """Pin K1's config for a shape's M bucket (what :func:`measure` and
    :func:`load` call); a config the kernel does not take raises here."""
    key = _key(m, k, n, dtype)
    _TABLE[key] = check_config(k, n, config)
    if measured:
        _MEASURED.add(key)


def _cim_operands(m, k, n, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype_name(dtype) == "int8":
        a = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device=dev).to(
            getattr(torch, dtype_name(dtype)))
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    return (a, w, torch.tensor(0.05, device=dev),
            torch.ones(n, device=dev))


def measure(m: int, k: int, n: int, dtype=torch.int8, *,
            candidates: Iterable | None = None, iters: int = 3,
            device="cuda") -> tuple[MatmulConfig, dict]:
    """Time the ``cim_matmul`` wrapper (its quantize pass included) over
    candidate configs on seeded operands; record the fastest for the
    shape's bucket and return ``(best, {config: median_us})``.  On the
    CPU this times the plain version (a smoke of the recording path:
    the choice means nothing there)."""
    from repro_torch.kernels.cim_matmul import ops   # lazy: no cycle
    dev = device_lib.resolve(device)
    args = _cim_operands(m, k, n, dtype, dev)
    if candidates is None:
        candidates = candidate_configs(
            m, k, n, device_lib.sm_count(dev) if dev.type == "cuda" else 0)
    timings = {}
    for c in candidates:
        c = check_config(k, n, c)
        timings[c] = time_median_us(
            lambda c=c: ops.cim_matmul(*args, config=c), iters)
    best = min(timings, key=timings.get)
    record(m, k, n, dtype, best)
    return best, timings


# ---------------------------------------------------------------------------
# K2: paged decode splits
# ---------------------------------------------------------------------------

def _paged_key(batch: int, kvh: int, width: int, block_size: int,
               head_dim: int, groups: int,
               dtype) -> tuple[int, int, int, int, int, int, str]:
    return (m_bucket(batch), int(kvh), int(width), int(block_size),
            int(head_dim), int(groups), dtype_name(dtype))


def heuristic_paged_splits(batch: int, kvh: int, width: int,
                           block_size: int, dtype=torch.int8) -> int:
    """Split count from the decode shape alone: (batch x kv_heads)
    programs already run in parallel; split only to reach ~8 programs,
    never below one page per program."""
    del block_size, dtype
    par = max(1, batch * kvh)
    want = max(1, -(-8 // par))
    return min(width, next_pow2(want))


def choose_paged_splits(batch: int, kvh: int, width: int, block_size: int,
                        dtype=torch.int8, *, head_dim: int = 0,
                        groups: int = 1) -> int:
    """kv_splits of the CPU arm: a recorded entry, else the JAX package's
    heuristic (memoised)."""
    key = _paged_key(batch, kvh, width, block_size, head_dim, groups, dtype)
    if key not in _PAGED_TABLE:
        _PAGED_TABLE[key] = heuristic_paged_splits(batch, kvh, width,
                                                   block_size, dtype)
    return _PAGED_TABLE[key]


def _positive(what: str, value) -> int:
    if int(value) < 1:
        raise ValueError(f"{what} must be >= 1, got {value}")
    return int(value)


def record_paged(batch: int, kvh: int, width: int, block_size: int, dtype,
                 kv_splits: int, *, head_dim: int = 0, groups: int = 1,
                 measured: bool = True) -> None:
    """Pin kv_splits for a decode shape.  The card's decode reads measured
    entries only (the table also memoises the CPU heuristic)."""
    key = _paged_key(batch, kvh, width, block_size, head_dim, groups, dtype)
    _PAGED_TABLE[key] = _positive("kv_splits", kv_splits)
    if measured:
        _PAGED_MEASURED.add(key)


def measured_paged_splits(batch: int, kvh: int, width: int, block_size: int,
                          dtype=torch.int8, *, head_dim: int = 0,
                          groups: int = 1) -> int | None:
    """The measured (or loaded) kv_splits at this key, else None."""
    key = _paged_key(batch, kvh, width, block_size, head_dim, groups, dtype)
    return _PAGED_TABLE[key] if key in _PAGED_MEASURED else None


def paged_split_candidates(width: int) -> list[int]:
    """Pow2 split counts from 1 (whole table per program) up to one page
    per program."""
    cands, s = [], 1
    while s <= width:
        cands.append(s)
        s *= 2
    return cands


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


def paged_split_pages(batch: int, kvh: int, max_width: int, sm_count: int,
                      *, block_size: int = 16, dtype=torch.int8,
                      head_dim: int = 0, groups: int = 1) -> int:
    """Pages per split that an engine fixes for its decode kernel: those
    of the measured split count at the engine's own key (``max_width``
    its widest table) where one is recorded, else those of
    :func:`heuristic_paged_splits_cuda` at ``max_width``.  Entries at
    other widths never move it.

    A split then owns the same pages of a row at every narrower width
    (the kernel takes ``ceil(width / pps)`` splits, none more than at
    ``max_width``), so a row's partials and its merged output are the
    same bits whatever widths the rest of the batch sets: a request
    decodes alike beside any neighbours, which page-out preemption and
    snapshot restore on the card rely on."""
    width = max(1, max_width)
    splits = measured_paged_splits(batch, kvh, width, block_size, dtype,
                                   head_dim=head_dim, groups=groups)
    if splits is None:
        splits = heuristic_paged_splits_cuda(batch, kvh, width, sm_count)
    return -(-width // splits)


def _pool(gen, shape, dtype, dev):
    """A synthetic pool of ``shape`` pages: int8 codes with 0.05 bf16
    scales (a QTensor), or normal values of ``dtype``."""
    from repro_torch.core import quant
    if dtype_name(dtype) == "int8":
        codes = torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        return quant.QTensor(codes, torch.full((*shape[:-1], 1), 0.05,
                                               dtype=torch.bfloat16,
                                               device=dev))
    return torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype_name(dtype)))


def measure_paged(batch: int, kvh: int, width: int, block_size: int,
                  dtype=torch.int8, *, head_dim: int = 64, groups: int = 2,
                  candidates: Iterable[int] | None = None, iters: int = 3,
                  device="cuda") -> tuple[int, dict]:
    """Time ``paged_attention`` (decode + merge) over candidate split
    counts on the JAX package's synthetic pool (every row's table full);
    record the fastest and return ``(best, {kv_splits: median_us})``.
    On the CPU it times the plain versions (the choice means nothing)."""
    from repro_torch.kernels.paged_attention import ops   # lazy: no cycle
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (width + 1, block_size, kvh, head_dim)
    k_pages, v_pages = (_pool(gen, shape, dtype, dev) for _ in range(2))
    q = torch.randn((batch, 1, kvh * groups, head_dim), generator=gen,
                    device=dev)
    tables = torch.arange(1, width + 1, dtype=torch.int32,
                          device=dev)[None].repeat(batch, 1)
    n_valid = torch.full((batch,), width * block_size, dtype=torch.int32,
                         device=dev)
    timings = {}
    for s in (candidates or paged_split_candidates(width)):
        timings[s] = time_median_us(
            lambda s=s: ops.paged_attention(q, k_pages, v_pages, tables,
                                            n_valid, kv_splits=s), iters)
    best = min(timings, key=timings.get)
    record_paged(batch, kvh, width, block_size, dtype, best,
                 head_dim=head_dim, groups=groups)
    return best, timings


# ---------------------------------------------------------------------------
# K3: chunked prefill's tokens per chunk
# ---------------------------------------------------------------------------

def _prefill_key(batch: int, kvh: int, block_size: int, head_dim: int,
                 groups: int, dtype) -> tuple[int, int, int, int, int, str]:
    return (m_bucket(batch), int(kvh), int(block_size), int(head_dim),
            int(groups), dtype_name(dtype))


def heuristic_prefill_chunk(block_size: int) -> int:
    """~64 tokens per chunk, always a block_size multiple."""
    return block_size * max(1, 64 // block_size)


def choose_prefill_chunk(batch: int, kvh: int, block_size: int,
                         dtype=torch.int8, *, head_dim: int = 0,
                         groups: int = 1) -> int:
    """Prefill chunk length for one serve shape: a recorded entry, else
    the heuristic (memoised)."""
    key = _prefill_key(batch, kvh, block_size, head_dim, groups, dtype)
    if key not in _PREFILL_TABLE:
        _PREFILL_TABLE[key] = heuristic_prefill_chunk(block_size)
    return _PREFILL_TABLE[key]


def _chunk(chunk_len, block_size: int) -> int:
    if int(chunk_len) < 1 or int(chunk_len) % int(block_size):
        raise ValueError(f"chunk_len {chunk_len} is not a positive multiple "
                         f"of block_size {block_size}")
    return int(chunk_len)


def record_prefill(batch: int, kvh: int, block_size: int, dtype,
                   chunk_len: int, *, head_dim: int = 0, groups: int = 1,
                   measured: bool = True) -> None:
    key = _prefill_key(batch, kvh, block_size, head_dim, groups, dtype)
    _PREFILL_TABLE[key] = _chunk(chunk_len, block_size)
    if measured:
        _PREFILL_MEASURED.add(key)


def prefill_chunk_candidates(block_size: int, cap: int = 256) -> list[int]:
    """Pow2-spaced block_size multiples from one page up to `cap` tokens."""
    cands, c = [], block_size
    while c <= max(cap, block_size):
        cands.append(c)
        c *= 2
    return cands


def measure_prefill(batch: int, kvh: int, block_size: int, dtype=torch.int8,
                    *, head_dim: int = 64, groups: int = 2,
                    candidates: Iterable[int] | None = None, iters: int = 3,
                    device="cuda") -> tuple[int, dict]:
    """Time ``paged_prefill`` over candidate chunk lengths on the JAX
    package's synthetic pool (one mid-prompt chunk: as many past tokens
    as the chunk holds) and pick the cheapest per token; record it and
    return ``(best, {chunk: median_us_per_token})``.  On the CPU it
    times the plain version (the choice means nothing)."""
    from repro_torch.kernels.paged_attention import ops   # lazy: no cycle
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    timings = {}
    for c in (candidates or prefill_chunk_candidates(block_size)):
        w = 2 * (c // block_size)            # past pages + chunk pages
        shape = (w * batch + 1, block_size, kvh, head_dim)
        k_pages, v_pages = (_pool(gen, shape, dtype, dev) for _ in range(2))
        q = torch.randn((batch, c, kvh * groups, head_dim), generator=gen,
                        device=dev)
        kn = torch.randn((batch, c, kvh, head_dim), generator=gen,
                         device=dev)
        tables = torch.arange(1, batch * w + 1, dtype=torch.int32,
                              device=dev).reshape(batch, w)
        pos = torch.full((batch,), c, dtype=torch.int32, device=dev)

        def run(q=q, kn=kn, k_pages=k_pages, v_pages=v_pages,
                tables=tables, pos=pos):
            return ops.paged_prefill(q, kn, kn, k_pages, v_pages, tables,
                                     pos, pos)
        timings[c] = time_median_us(run, iters) / c
    best = min(timings, key=timings.get)
    record_prefill(batch, kvh, block_size, dtype, best, head_dim=head_dim,
                   groups=groups)
    return best, timings


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def dump(path: str | None = None) -> str:
    """Write the measured entries as JSON to ``path`` (or
    ``$REPRO_TORCH_AUTOTUNE_CACHE``); returns the text (also when no path
    is given)."""
    gemm = [dict(zip(("m_bucket", "k", "n", "dtype"), key),
                 **_TABLE[key]._asdict()) for key in sorted(_MEASURED)]
    paged = [{"batch_bucket": key[0], "kvh": key[1], "width": key[2],
              "block_size": key[3], "head_dim": key[4], "groups": key[5],
              "dtype": key[6], "kv_splits": _PAGED_TABLE[key]}
             for key in sorted(_PAGED_MEASURED)]
    prefill = [{"batch_bucket": key[0], "kvh": key[1], "block_size": key[2],
                "head_dim": key[3], "groups": key[4], "dtype": key[5],
                "chunk_len": _PREFILL_TABLE[key]}
               for key in sorted(_PREFILL_MEASURED)]
    text = json.dumps({
        "version": 1,
        "device": (torch.cuda.get_device_name() if torch.cuda.is_available()
                   else "cpu"),
        "gemm_entries": gemm, "paged_entries": paged,
        "prefill_entries": prefill}, indent=2)
    path = path or os.environ.get(CACHE_ENV)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def load(path_or_text: str) -> int:
    """Load a dumped table (a path or inline JSON) written by this module
    or by the JAX package's autotuner; returns the entries loaded.  A JAX
    file's TPU block ``entries`` mean nothing on the card and are skipped
    (not counted).  Every entry is checked before any is recorded, so a
    file with a config the kernel does not take changes nothing."""
    text = path_or_text
    if not path_or_text.lstrip().startswith("{"):
        with open(path_or_text) as f:
            text = f.read()
    obj = json.loads(text)
    gemm = [((e["m_bucket"], e["k"], e["n"], e["dtype"]),
             check_config(e["k"], e["n"],
                          (e["path"], e["nt"], e["bt"], e["splits"])))
            for e in obj.get("gemm_entries", ())]
    paged = [((e["batch_bucket"], e["kvh"], e["width"], e["block_size"],
               e["dtype"], _positive("kv_splits", e["kv_splits"])),
              {"head_dim": e.get("head_dim", 0), "groups": e.get("groups", 1)})
             for e in obj.get("paged_entries", ())]
    prefill = [((e["batch_bucket"], e["kvh"], e["block_size"], e["dtype"],
                 _chunk(e["chunk_len"], e["block_size"])),
                {"head_dim": e.get("head_dim", 0),
                 "groups": e.get("groups", 1)})
               for e in obj.get("prefill_entries", ())]
    for args, cfg in gemm:
        record(*args, cfg)
    for args, kw in paged:
        record_paged(*args, **kw)
    for args, kw in prefill:
        record_prefill(*args, **kw)
    return len(gemm) + len(paged) + len(prefill)


def clear() -> None:
    """Drop every recorded and memoised decision."""
    for table in (_TABLE, _MEASURED, _PAGED_TABLE, _PAGED_MEASURED,
                  _PREFILL_TABLE, _PREFILL_MEASURED):
        table.clear()
