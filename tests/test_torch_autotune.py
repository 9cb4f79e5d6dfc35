"""The port's autotuner against the JAX package's: the shared heuristics,
the record/choose semantics of the K2 split and K3 chunk tables, tables
dumped by either package loaded into the other, and the card's K1
config table (checked on the CPU from shapes alone: with nothing recorded
it is today's heuristic, and it refuses configs the kernel does not
take).  The timings themselves run on the card (``chip_smoke.py``'s
autotune phase); here ``measure*`` time the plain versions as a smoke of
the recording path."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import autotune as ja
from repro.models import model as JM
from repro.serve import ContinuousEngine as JEngine
from repro_torch import configs as tcfg
from repro_torch.kernels import autotune as ta
from repro_torch.models import model as TM
from repro_torch.serve import ContinuousEngine as TEngine
from test_torch_gemm_dispatch import (H100_SMS, SERVING_KN, SERVING_M,
                                      VGG8_MKN, _instantiated)

# (batch, kvh, width, block_size, head_dim, groups, dtype) decode keys
# and (batch, kvh, block_size, head_dim, groups, dtype) prefill keys.
PAGED_KEYS = [(b, kvh, w, bs, d, g, dt) for b in (1, 5, 8, 32)
              for kvh, g in ((8, 4), (2, 2)) for w in (4, 31, 511)
              for bs in (8, 16) for d in (64, 128) for dt in ("int8",
                                                              "float32")]
PREFILL_KEYS = [(b, kvh, bs, d, g, dt) for b in (1, 8, 9) for kvh, g in
                ((8, 4), (2, 2)) for bs in (8, 16, 32) for d in (64, 128)
                for dt in ("int8", "float32")]


@pytest.fixture(autouse=True)
def _fresh_tables():
    ja.clear()
    ta.clear()
    yield
    ja.clear()
    ta.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these many small CPU ops gain nothing from
    more, and the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdt(name):
    return jnp.dtype(name)


def _tdt(name):
    return getattr(torch, name)


def test_heuristics_equal_jax():
    for x in range(0, 1100):
        assert ta.next_pow2(x) == ja.next_pow2(x)
        assert ta.m_bucket(x) == ja.m_bucket(x)
    for b, kvh, w, bs, *_ in PAGED_KEYS:
        assert (ta.heuristic_paged_splits(b, kvh, w, bs)
                == ja.heuristic_paged_splits(b, kvh, w, bs))
        assert ta.paged_split_candidates(w) == ja.paged_split_candidates(w)
    for bs in (1, 4, 8, 16, 32, 48, 64, 128):
        assert ta.heuristic_prefill_chunk(bs) == ja.heuristic_prefill_chunk(
            bs)
        for cap in (64, 256, 512):
            assert (ta.prefill_chunk_candidates(bs, cap)
                    == ja.prefill_chunk_candidates(bs, cap))
        assert ta.prefill_chunk_candidates(bs) == \
            ja.prefill_chunk_candidates(bs)


@pytest.mark.parametrize("name", ["int8", "float32", "bfloat16", "float16",
                                  "int32"])
def test_dtype_names_are_jax_names(name):
    """A key built from a torch dtype or a name holds JAX's name
    ("int8", never "torch.int8")."""
    want = jnp.dtype(name).name
    assert ta.dtype_name(_tdt(name)) == want
    assert ta.dtype_name(name) == want
    assert ta.dtype_name(f"torch.{name}") == want
    for bad in ("int9", "Tensor", None):
        with pytest.raises(ValueError, match="dtype"):
            ta.dtype_name(bad)


def test_record_choose_semantics_equal_jax():
    """A record overrides the heuristic, a memoised heuristic is stable,
    and dump writes measured entries only: the same in both packages."""
    for pkg, dt in ((ja, _jdt), (ta, _tdt)):
        h = pkg.choose_paged_splits(8, 8, 511, 16, dt("int8"), head_dim=128,
                                    groups=4)
        assert h == pkg.choose_paged_splits(8, 8, 511, 16, dt("int8"),
                                            head_dim=128, groups=4)
        pkg.record_paged(8, 8, 511, 16, dt("int8"), 64, head_dim=128,
                         groups=4)
        # Batches 5..8 share the bucket of 8.
        assert pkg.choose_paged_splits(5, 8, 511, 16, dt("int8"),
                                       head_dim=128, groups=4) == 64
        pkg.record_paged(8, 8, 31, 16, dt("int8"), 2, head_dim=128,
                         groups=4, measured=False)
        assert pkg.choose_paged_splits(8, 8, 31, 16, dt("int8"),
                                       head_dim=128, groups=4) == 2
        assert pkg.choose_prefill_chunk(8, 8, 16, dt("int8"), head_dim=128,
                                        groups=4) == 64
        pkg.record_prefill(8, 8, 16, dt("int8"), 128, head_dim=128,
                           groups=4)
        assert pkg.choose_prefill_chunk(7, 8, 16, dt("int8"), head_dim=128,
                                        groups=4) == 128
        pkg.record_prefill(1, 2, 16, dt("float32"), 32, head_dim=64,
                           groups=2, measured=False)
    jobj, tobj = json.loads(ja.dump()), json.loads(ta.dump())
    assert jobj["paged_entries"] == tobj["paged_entries"]
    assert jobj["prefill_entries"] == tobj["prefill_entries"]
    assert [e["kv_splits"] for e in tobj["paged_entries"]] == [64]
    assert [e["chunk_len"] for e in tobj["prefill_entries"]] == [128]
    assert tobj["gemm_entries"] == [] and tobj["version"] == 1
    assert tobj["device"] == "cpu" and "entries" not in tobj


def _record_grid(pkg, dt, seed):
    """Record a seeded choice at every third key of the grids."""
    rng = np.random.default_rng(seed)
    for b, kvh, w, bs, d, g, name in PAGED_KEYS[::3]:
        pkg.record_paged(b, kvh, w, bs, dt(name), int(rng.integers(1, 64)),
                         head_dim=d, groups=g)
    for b, kvh, bs, d, g, name in PREFILL_KEYS[::3]:
        pkg.record_prefill(b, kvh, bs, dt(name),
                           bs * int(rng.integers(1, 9)), head_dim=d,
                           groups=g)


def _choices(pkg, dt):
    return ([pkg.choose_paged_splits(b, kvh, w, bs, dt(name), head_dim=d,
                                     groups=g)
             for b, kvh, w, bs, d, g, name in PAGED_KEYS],
            [pkg.choose_prefill_chunk(b, kvh, bs, dt(name), head_dim=d,
                                      groups=g)
             for b, kvh, bs, d, g, name in PREFILL_KEYS])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tables_load_across_packages(tmp_path, writer):
    """A table either package dumps loads into the other, and the split
    and chunk choices are equal key for key.  A JAX file's TPU block
    entries are skipped and not counted."""
    src, dst, src_dt, dst_dt = ((ja, ta, _jdt, _tdt) if writer == "jax"
                                else (ta, ja, _tdt, _jdt))
    _record_grid(src, src_dt, seed=3)
    if writer == "jax":
        ja.record(16, 512, 256, jnp.int8, (16, 128, 256))
    path = tmp_path / "table.json"
    src.dump(str(path))
    want = _choices(src, src_dt)
    src.clear()
    ref = json.loads(path.read_text())
    n = dst.load(str(path))
    assert n == len(ref["paged_entries"]) + len(ref["prefill_entries"]) > 40
    assert _choices(dst, dst_dt) == want
    # The loaded entries are measured ones: they dump again unchanged.
    again = json.loads(dst.dump())
    for field in ("paged_entries", "prefill_entries"):
        assert again[field] == ref[field]
    if writer == "jax":
        assert ta._TABLE == {}


def test_dump_defaults_to_the_cache_env(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv(ta.CACHE_ENV, str(path))
    assert ta.CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE" != ja.CACHE_ENV
    ta.record_prefill(8, 8, 16, torch.int8, 32, head_dim=128, groups=4)
    text = ta.dump()
    assert path.read_text() == text
    ta.clear()
    assert ta.load(text) == 1
    assert ta.choose_prefill_chunk(8, 8, 16, torch.int8, head_dim=128,
                                   groups=4) == 32


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_choose_config_is_todays_heuristic_with_no_table(dtype):
    """With nothing recorded K1's choice is cim_matmul_config of the exact
    M (not one memoised per bucket), at every serving and VGG-8 shape."""
    shapes = ([(m, k, n) for k, n in SERVING_KN for m in SERVING_M]
              + list(VGG8_MKN))
    for m, k, n in shapes:
        assert (ta.choose_config(m, k, n, dtype, H100_SMS)
                == ta.cim_matmul_config(m, n, k, H100_SMS))
    # Bucket 1024 holds M = 513 (5 token tiles of N = 768: 8 splits to
    # fill the card) and 641 (6 tiles: 4 splits).
    assert (ta.choose_config(513, 4096, 768, dtype, H100_SMS).splits
            != ta.choose_config(641, 4096, 768, dtype, H100_SMS).splits)
    assert ta._TABLE == {}


def test_candidate_configs_are_what_the_kernel_takes():
    """Every candidate is a tile pair the C entry point instantiates,
    with a power-of-two split leaving no split empty; the heuristic's
    comes first; ragged shapes have the masked path alone."""
    tiles = _instantiated("cim_matmul")
    assert set(ta.WGMMA_TILES) == tiles
    for m, k, n in [(8, 4096, 12288), (512, 12288, 4096), (3, 64, 64),
                    (17, 1152, 128), (9, 100, 36)]:
        cands = ta.candidate_configs(m, k, n, H100_SMS)
        assert cands[0] == ta.cim_matmul_config(m, n, k, H100_SMS)
        assert len(set(cands)) == len(cands)
        if k % 16 or n % 16:
            assert cands == [ta.MASKED]
            continue
        steps = -(-k // ta.GEMM_BK)
        for c in cands:
            assert c.path == "wgmma" and (c.nt, c.bt) in tiles
            assert c.splits & (c.splits - 1) == 0
            assert 1 <= c.splits <= ta.GEMM_MAX_SPLITS
            assert (c.splits - 1) * -(-steps // c.splits) < steps
        splits = {c.splits for c in cands}
        assert len(cands) == len(tiles) * len(splits)
    # K = 64 is one K step: no split but 1.
    assert {c.splits for c in ta.candidate_configs(8, 64, 64, 132)} == {1}


def test_record_overrides_k1_for_the_bucket():
    cfg = ta.MatmulConfig("wgmma", 1, 16, 4)
    ta.record(8, 4096, 4096, torch.int8, cfg)
    for m in range(1, 9):
        assert ta.choose_config(m, 4096, 4096, torch.int8, H100_SMS) == cfg
        assert ta.choose_config(m, 4096, 4096, torch.float32, H100_SMS) \
            == ta.cim_matmul_config(m, 4096, 4096, H100_SMS)
    assert ta.choose_config(9, 4096, 4096, torch.int8, H100_SMS) \
        == ta.cim_matmul_config(9, 4096, 4096, H100_SMS)
    ta.record(300, 4096, 1024, "float32", ("wgmma", 2, 64, 2),
              measured=False)
    entries = json.loads(ta.dump())["gemm_entries"]
    assert entries == [{"m_bucket": 8, "k": 4096, "n": 4096,
                        "dtype": "int8", "path": "wgmma", "nt": 1,
                        "bt": 16, "splits": 4}]
    ta.clear()
    assert ta.load(json.dumps({"gemm_entries": entries})) == 1
    assert ta.choose_config(3, 4096, 4096, torch.int8, H100_SMS) == cfg


@pytest.mark.parametrize("config", [
    ("wgmma", 2, 32, 1),         # a tile pair the kernel lacks
    ("wgmma", 2, 16, 3),         # not a power of two
    ("wgmma", 2, 16, 32),        # beyond a cluster
    ("wgmma", 1, 8, 16),         # K = 512 has 8 steps: splits 16 empty
    ("masked", 0, 0, 1),         # aligned shapes take wgmma
    ("tiles", 2, 16, 1)])
def test_invalid_configs_are_refused_at_record_and_load(config):
    with pytest.raises(ValueError, match="K=512, N=256"):
        ta.record(8, 512, 256, torch.int8, config)
    good = {"m_bucket": 8, "k": 4096, "n": 4096, "dtype": "int8",
            "path": "wgmma", "nt": 2, "bt": 8, "splits": 2}
    bad = dict(zip(("path", "nt", "bt", "splits"), config), m_bucket=8,
               k=512, n=256, dtype="int8")
    with pytest.raises(ValueError, match="K=512, N=256"):
        ta.load(json.dumps({"gemm_entries": [good, bad]}))
    assert ta._TABLE == {} and ta._MEASURED == set()
    with pytest.raises(ValueError, match="K=64, N=36"):
        ta.record(8, 64, 36, torch.int8, ("wgmma", 2, 8, 1))
    ta.record(8, 64, 36, torch.int8, ta.MASKED)


def test_invalid_splits_and_chunks_are_refused():
    with pytest.raises(ValueError, match="kv_splits"):
        ta.record_paged(8, 8, 64, 16, torch.int8, 0)
    with pytest.raises(ValueError, match="block_size"):
        ta.record_prefill(8, 8, 16, torch.int8, 24)
    bad = {"prefill_entries": [{"batch_bucket": 8, "kvh": 8,
                                "block_size": 16, "head_dim": 128,
                                "groups": 4, "dtype": "int8",
                                "chunk_len": 0}]}
    with pytest.raises(ValueError, match="block_size"):
        ta.load(json.dumps(bad))
    assert ta._PREFILL_TABLE == {}


def test_engine_split_pages_read_only_its_own_key():
    """The card's pages per split: a measured split at the engine's own
    key (its widest table) sets them; entries at other widths, memoised
    CPU heuristics and unmeasured records do not."""
    key = dict(block_size=16, dtype=torch.int8, head_dim=128, groups=4)
    heur = ta.paged_split_pages(8, 8, 511, H100_SMS, **key)
    assert heur == -(-511 // ta.heuristic_paged_splits_cuda(8, 8, 511,
                                                             H100_SMS))
    ta.choose_paged_splits(8, 8, 511, 16, torch.int8, head_dim=128,
                           groups=4)
    ta.record_paged(8, 8, 256, 16, torch.int8, 2, head_dim=128, groups=4)
    ta.record_paged(8, 8, 511, 16, torch.int8, 2, head_dim=128, groups=4,
                    measured=False)
    assert ta.paged_split_pages(8, 8, 511, H100_SMS, **key) == heur
    ta.record_paged(8, 8, 511, 16, torch.int8, 32, head_dim=128, groups=4)
    assert ta.paged_split_pages(8, 8, 511, H100_SMS, **key) == 16
    assert ta.paged_split_pages(8, 8, 511, H100_SMS, **dict(
        key, dtype=torch.bfloat16)) == heur
    assert ta.measured_paged_splits(5, 8, 511, 16, "int8", head_dim=128,
                                    groups=4) == 32


def test_measure_smokes_record_a_choice_on_cpu():
    best, timings = ta.measure(8, 64, 32, torch.float32, iters=1,
                               device="cpu")
    assert best in timings and set(timings) == set(
        ta.candidate_configs(8, 64, 32, 0))
    assert ta.choose_config(5, 64, 32, torch.float32, H100_SMS) == best
    best, timings = ta.measure_paged(2, 2, 4, 4, torch.int8, head_dim=32,
                                     groups=2, iters=1, device="cpu")
    assert set(timings) == {1, 2, 4}
    assert ta.choose_paged_splits(2, 2, 4, 4, torch.int8, head_dim=32,
                                  groups=2) == best
    best, timings = ta.measure_prefill(2, 2, 4, torch.float32, head_dim=32,
                                       groups=2, candidates=(4, 8),
                                       iters=1, device="cpu")
    assert set(timings) == {4, 8}
    assert ta.choose_prefill_chunk(2, 2, 4, torch.float32, head_dim=32,
                                   groups=2) == best
    assert len(json.loads(ta.dump())["gemm_entries"]) == 1


def test_engines_take_the_same_loaded_chunk():
    """After one file is loaded into both packages, JAX's and the port's
    ContinuousEngine (reduced qwen3-8b, int8 pool) take its chunk."""
    import dataclasses
    jc = dataclasses.replace(jcfg.reduced_config("qwen3-8b", n_layers=1),
                             kv_cache_dtype="int8")
    tc = dataclasses.replace(tcfg.reduced_config("qwen3-8b", n_layers=1),
                             kv_cache_dtype="int8")
    entry = {"batch_bucket": 8, "kvh": tc.n_kv_heads, "block_size": 16,
             "head_dim": tc.resolved_head_dim,
             "groups": tc.n_heads // tc.n_kv_heads, "dtype": "int8",
             "chunk_len": 32}
    text = json.dumps({"version": 1, "prefill_entries": [entry]})
    assert ja.load(text) == ta.load(text) == 1
    je = JEngine(JM.init(jax.random.PRNGKey(0), jc), jc, max_batch=6,
                 kv_blocks=8, chunked_prefill=True)
    te = TEngine(TM.init(tc, torch.Generator().manual_seed(0),
                         device="cpu"), tc, max_batch=6, kv_blocks=8,
                 chunked_prefill=True, device="cpu")
    assert je.prefill_chunk == te.prefill_chunk == 32
    ja.clear()
    ta.clear()
    assert (JEngine(JM.init(jax.random.PRNGKey(0), jc), jc, max_batch=6,
                    kv_blocks=8).prefill_chunk
            == TEngine(TM.init(tc, torch.Generator().manual_seed(0),
                               device="cpu"), tc, max_batch=6, kv_blocks=8,
                       device="cpu").prefill_chunk
            == ta.heuristic_prefill_chunk(16))
