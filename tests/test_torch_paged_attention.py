"""Port parity: the plain twins of the paged decode and chunked paged
prefill kernels against the JAX package's vectorized versions
(``flash_decode_jnp`` / ``flash_prefill_jnp`` / ``write_chunk_pages``) and
its gather references, on identical numpy inputs.

Tolerances: fp attention within 1e-5 (the same f32 math, summed in another
order); int8 page bytes (codes and bf16 scales) bit-exact; block 0, the
null block, is garbage by contract and excluded.  A row with no live
positions returns zeros in the port and is kept out of the comparison
with the dense reference (ROADMAP queue 3).  The CUDA kernels themselves
are held against these twins on the card (test_torch_kernels_gpu.py and
chip_smoke.py)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import autotune as jautotune
from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro_torch import convert
from repro_torch.core import quant as tq
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import ref as tref

B, KVH, G, D, BS, NB, W = 3, 2, 2, 16, 4, 16, 6
H = KVH * G


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _pool(int8: bool, seed: int, shape=(NB, BS, KVH, D)):
    """Both packages' view of one random pool: (jax pages, torch pages)."""
    rng = np.random.default_rng(seed)
    if int8:
        out = []
        for _ in range(2):
            codes = rng.integers(-127, 128, shape).astype(np.int8)
            scale = (rng.random((*shape[:-1], 1)) * 0.05 + 0.01).astype(
                ml_dtypes.bfloat16)
            out.append((jq.QTensor(jnp.asarray(codes), jnp.asarray(scale)),
                        tq.QTensor(_t(codes), _t(scale))))
        return out
    return [(jnp.asarray(a), _t(a)) for a in
            (rng.standard_normal(shape).astype(np.float32)
             for _ in range(2))]


def _tables():
    tables = np.zeros((B, W), np.int32)
    tables[0, :5] = [3, 9, 1, 12, 7]
    tables[1, :1] = [4]
    tables[2, :6] = [2, 5, 6, 8, 10, 11]
    return tables


def _split(p):
    if isinstance(p, (jq.QTensor, tq.QTensor)):
        return p.q, p.scale[..., 0]
    return p, None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kv_splits", [1, 2, 4])
def test_decode_plain_matches_jax(int8, kv_splits):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    n_valid = np.array([17, 0, 23], np.int32)
    (jk, tk), (jv, tv) = _pool(int8, 1)
    tables = _tables()
    want = jops.flash_decode_jnp(
        jnp.asarray(q), *_split(jk), *_split(jv), jnp.asarray(tables),
        jnp.asarray(n_valid), kv_splits=kv_splits)
    tkq, tks = _split(tk)
    tvq, tvs = _split(tv)
    got = tops.merge_splits(*tops.paged_attention_plain(
        _t(q), tkq, tvq, tks, tvs, _t(tables), _t(n_valid),
        kv_splits=kv_splits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[1].any(), "the n_valid=0 row must be zeros"
    # the public wrapper (CPU tensor -> plain twin) against the JAX
    # gather reference, live rows only
    q4 = q.reshape(B, 1, H, D)
    out = tops.paged_attention(_t(q4), tk, tv, _t(tables), _t(n_valid),
                               kv_splits=kv_splits).numpy()
    ref = (jref.dequant_attention_ref if int8 else jref.paged_attention_ref)(
        jnp.asarray(q4), jk, jv, jnp.asarray(tables), jnp.asarray(n_valid))
    live = n_valid > 0
    np.testing.assert_allclose(out[live], np.asarray(ref)[live], rtol=1e-5,
                               atol=1e-5)


H100_SMS = 132


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("width", [4, 16, 128])
def test_decode_plain_at_card_splits_matches_jax(batch, width):
    """The split counts the CUDA heuristic picks for the serving shapes
    (KVH = 8, an H100's 132 SMs) merge to JAX's flash_decode_jnp at those
    counts, an empty row included."""
    kvh, g, d, bs = 8, 4, 16, 4
    splits = tautotune.heuristic_paged_splits_cuda(batch, kvh, width,
                                                   H100_SMS)
    rng = np.random.default_rng(width + batch)
    nb = batch * width + 1
    tables = (rng.permutation(nb - 1)[:batch * width] + 1).reshape(
        batch, width).astype(np.int32)
    n_valid = rng.integers(1, width * bs + 1, batch).astype(np.int32)
    n_valid[-1] = 0
    q = rng.standard_normal((batch, kvh, g, d)).astype(np.float32)
    (jk, tk), (jv, tv) = _pool(True, 11, (nb, bs, kvh, d))
    want = jops.flash_decode_jnp(
        jnp.asarray(q), *_split(jk), *_split(jv), jnp.asarray(tables),
        jnp.asarray(n_valid), kv_splits=splits)
    tkq, tks = _split(tk)
    tvq, tvs = _split(tv)
    got = tops.merge_splits(*tops.paged_attention_plain(
        _t(q), tkq, tvq, tks, tvs, _t(tables), _t(n_valid),
        kv_splits=splits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[-1].any(), "the n_valid=0 row must be zeros"


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kvh", [1, 2, 8])
def test_cuda_split_heuristic(sms, kvh):
    """A power of two; every split owns at least one page of the table;
    at least two blocks per SM unless the width caps it; the smallest such
    power of two."""
    for batch in (1, 2, 3, 8, 17, 64, 256):
        for width in (1, 2, 3, 4, 6, 8, 16, 100, 128, 256, 1024):
            s = tautotune.heuristic_paged_splits_cuda(batch, kvh, width, sms)
            assert s >= 1 and s & (s - 1) == 0
            pps = -(-width // s)
            assert (s - 1) * pps < width        # no split without a page
            capped = (2 * s - 1) * -(-width // (2 * s)) >= width
            assert batch * kvh * s >= 2 * sms or capped
            assert s == 1 or batch * kvh * (s // 2) < 2 * sms


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kvh", [1, 8])
@pytest.mark.parametrize("batch", [1, 8])
def test_engine_split_pages(sms, kvh, batch):
    """An engine's fixed pages per split: at its widest table it gives the
    heuristic's split count, and no narrower width takes more splits, so
    the grid is never wider than the heuristic's at the widest table;
    every split owns a page."""
    for max_w in (4, 32, 127, 512):
        pps = tautotune.paged_split_pages(batch, kvh, max_w, sms)
        ns_max, _ = tops.split_geometry(max_w, split_pages=pps)
        assert ns_max == tautotune.heuristic_paged_splits_cuda(
            batch, kvh, max_w, sms)
        for w in range(1, max_w + 1):
            ns, got = tops.split_geometry(w, split_pages=pps)
            assert got == pps and (ns - 1) * pps < w and ns <= ns_max


@pytest.mark.parametrize("int8", [False, True])
def test_decode_plain_split_pages_width_invariant(int8):
    """With pages per split fixed, a row's decode output through the
    wrapper is the same bits at every table width (extra splits are
    empty and merge as exact zeros), and equals JAX's decode."""
    rng = np.random.default_rng(9)
    b, nb = 3, 40
    tables = np.zeros((b, 37), np.int32)
    tables[:, :10] = (rng.permutation(nb - 1)[:3 * 10] + 1).reshape(b, 10)
    n_valid = np.array([10 * BS, 3 * BS + 1, 0], np.int32)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _pool(int8, 4, (nb, BS, KVH, D))
    outs = [tops.paged_attention(_t(q), tk, tv, _t(tables[:, :w].copy()),
                                 _t(n_valid), split_pages=4)
            for w in (10, 12, 16, 37)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = jops.paged_attention(jnp.asarray(q), jk, jv,
                                jnp.asarray(tables[:, :16]),
                                jnp.asarray(n_valid))
    np.testing.assert_allclose(outs[0].numpy()[:2], np.asarray(want)[:2],
                               rtol=1e-5, atol=1e-5)
    assert not outs[0][2].any()


def test_cpu_split_heuristic_is_jax():
    """On CPU tensors the decode wrapper keeps the JAX package's split
    heuristic, so CPU parity with JAX is unchanged."""
    for batch in (1, 2, 3, 8, 64):
        for kvh in (1, 2, 8):
            for width in (1, 3, 4, 16, 128):
                assert (tautotune.heuristic_paged_splits(batch, kvh, width,
                                                         16)
                        == jautotune.heuristic_paged_splits(batch, kvh,
                                                            width, 16))
    seen = []
    plain = tops.paged_attention_plain

    def spy(*a, kv_splits):
        seen.append(kv_splits)
        return plain(*a, kv_splits=kv_splits)

    (_, tk), (_, tv) = _pool(True, 1)
    q = np.random.default_rng(0).standard_normal((1, 1, H, D)).astype(
        np.float32)
    tables = _tables()[:1]
    import unittest.mock
    with unittest.mock.patch.object(tops, "paged_attention_plain", spy):
        tops.paged_attention(_t(q), tk, tv, _t(tables),
                             _t(np.array([17], np.int32)))
    assert seen == [jautotune.heuristic_paged_splits(1, KVH, W, BS)]


def test_decode_reference_impls_match_jax():
    """The gather-then-attend references (fp and fully-integer int8) agree
    with the JAX package's on live rows."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    n_valid = np.array([9, 3, 24], np.int32)
    tables = _tables()
    for int8 in (False, True):
        (jk, tk), (jv, tv) = _pool(int8, 2)
        want = jref.paged_attention_ref(jnp.asarray(q), jk, jv,
                                        jnp.asarray(tables),
                                        jnp.asarray(n_valid))
        got = tref.paged_attention_ref(_t(q), tk, tv, _t(tables),
                                       _t(n_valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _prefill_inputs(seed=0):
    rng = np.random.default_rng(seed)
    c = 8
    q = rng.standard_normal((B, c, H, D)).astype(np.float32)
    k_new = rng.standard_normal((B, c, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, c, KVH, D)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    tables[0, :4] = [1, 2, 3, 4]        # 8 past tokens + full chunk
    tables[1, :2] = [5, 6]              # fresh prompt, ragged 5-token tail
    tables[2, :4] = [7, 8, 9, 10]       # 8 past tokens, masked row
    pos = np.array([8, 0, 8], np.int32)
    n_tok = np.array([8, 5, 8], np.int32)
    wm = np.array([1, 1, 0], np.int32)
    return q, k_new, v_new, tables, pos, n_tok, wm


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("jax_backend", ["emulate", "interpret"])
def test_prefill_plain_matches_jax(int8, jax_backend):
    """Attention within 1e-5 and written pages bit-exact (int8 codes and
    scales from the quantize_kv grid) against JAX; the masked row's pages
    keep their bytes.  A masked row's output is discarded by every caller
    (the JAX kernel leaves it zero, its emulation and the port attend), so
    only prefilling rows are compared."""
    q, k_new, v_new, tables, pos, n_tok, wm = _prefill_inputs()
    (jk, tk), (jv, tv) = _pool(int8, 3)
    before = [t.q.clone() if int8 else t.clone() for t in (tk, tv)]
    jout, jk2, jv2 = jops.paged_prefill(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jk, jv,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_tok),
        jnp.asarray(wm), backend=jax_backend)
    tout, tk2, tv2 = tops.paged_prefill(
        _t(q), _t(k_new), _t(v_new), tk, tv, _t(tables), _t(pos),
        _t(n_tok), _t(wm))
    on = wm.astype(bool)
    np.testing.assert_allclose(tout.numpy()[on], np.asarray(jout)[on],
                               rtol=1e-5, atol=1e-5)
    for got, want in ((tk2, jk2), (tv2, jv2)):
        if int8:
            np.testing.assert_array_equal(got.q.numpy()[1:],
                                          np.asarray(want.q)[1:])
            np.testing.assert_array_equal(
                got.scale.view(torch.int16).numpy()[1:],
                np.asarray(want.scale).view(np.int16)[1:])
        else:
            np.testing.assert_array_equal(got.numpy()[1:],
                                          np.asarray(want)[1:])
    for got, old in zip((tk2, tv2), before):
        cur = got.q if int8 else got
        # masked row 2 owns blocks 9, 10 for its chunk: untouched
        assert torch.equal(cur[[9, 10]], old[[9, 10]])
    # pages_from_jax carries the JAX pool across byte for byte
    import jax
    moved = convert.pages_from_jax(
        jax.tree.map(np.asarray, {"k": jk2, "v": jv2}))
    for name, want in (("k", jk2), ("v", jv2)):
        got = moved[name]
        if int8:
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(
                got.scale.view(torch.int16).numpy(),
                np.asarray(want.scale).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("jax_backend", ["emulate", "interpret"])
def test_prefill_plain_matches_jax_g1_bs8(int8, jax_backend):
    """G = 1 with 8-token blocks: a chunk of 16 tokens has more pages than
    16-row query tiles, the shape the CUDA wrapper used to refuse.  The
    plain twin (the CUDA kernel's oracle on the card) agrees with JAX:
    attention within 1e-5, pages bit-exact, the masked row's blocks
    untouched."""
    b, kvh, g, d, bs, c, w = 3, 2, 1, 16, 8, 16, 4
    nb = b * w + 1
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, c, kvh * g, d)).astype(np.float32)
    k_new = rng.standard_normal((b, c, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((b, c, kvh, d)).astype(np.float32)
    tables = np.arange(1, nb, dtype=np.int32).reshape(b, w)
    pos = np.array([16, 0, 16], np.int32)
    n_tok = np.array([16, 11, 16], np.int32)
    wm = np.array([1, 1, 0], np.int32)
    (jk, tk), (jv, tv) = _pool(int8, 5, (nb, bs, kvh, d))
    before = [t.q.clone() if int8 else t.clone() for t in (tk, tv)]
    jout, jk2, jv2 = jops.paged_prefill(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jk, jv,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_tok),
        jnp.asarray(wm), backend=jax_backend)
    tout, tk2, tv2 = tops.paged_prefill(
        _t(q), _t(k_new), _t(v_new), tk, tv, _t(tables), _t(pos),
        _t(n_tok), _t(wm))
    on = wm.astype(bool)
    np.testing.assert_allclose(tout.numpy()[on], np.asarray(jout)[on],
                               rtol=1e-5, atol=1e-5)
    for got, want in ((tk2, jk2), (tv2, jv2)):
        gq = got.q if int8 else got
        wq = want.q if int8 else want
        np.testing.assert_array_equal(gq.numpy()[1:], np.asarray(wq)[1:])
        if int8:
            np.testing.assert_array_equal(
                got.scale.view(torch.int16).numpy()[1:],
                np.asarray(want.scale).view(np.int16)[1:])
    masked = tables[2, 16 // bs:(16 + c) // bs]
    for got, old in zip((tk2, tv2), before):
        cur = got.q if int8 else got
        assert torch.equal(cur[masked], old[masked])


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_without_past_matches_past_walk(int8):
    """On a first chunk (every pos 0) the has_past=False shortcut, which
    skips the past gather, gives the same attention and page writes as
    the full past walk."""
    q, k_new, v_new, tables, _, n_tok, wm = _prefill_inputs(1)
    pos = np.zeros(B, np.int32)
    pools = [_pool(int8, 4), _pool(int8, 4)]
    outs = []
    for (_, tk), (_, tv) in pools:
        out, *_ = tops.paged_prefill(_t(q), _t(k_new), _t(v_new), tk, tv,
                                     _t(tables), _t(pos), _t(n_tok), _t(wm),
                                     has_past=len(outs) == 0)
        outs.append(out)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6,
                               atol=1e-6)
    for i in range(2):
        a, b = pools[0][i][1], pools[1][i][1]
        assert torch.equal(a.q if int8 else a, b.q if int8 else b)
        if int8:
            assert torch.equal(a.scale, b.scale)


def test_merge_splits_matches_jax():
    rng = np.random.default_rng(7)
    acc = rng.standard_normal((2, 2, 3, 2, 4)).astype(np.float32)
    m = rng.standard_normal((2, 2, 3, 2, 1)).astype(np.float32)
    m[0, 0, 1] = -1e30                      # a dead split
    l = rng.random((2, 2, 3, 2, 1)).astype(np.float32)
    l[0, 0, 1] = 0.0
    acc[0, 0, 1] = 0.0
    np.testing.assert_allclose(
        tops.merge_splits(_t(acc), _t(m), _t(l)).numpy(),
        np.asarray(jops.merge_splits(jnp.asarray(acc), jnp.asarray(m),
                                     jnp.asarray(l))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g,d", [(1, 128), (4, 160)])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_and_prefill_plain_at_family_shapes(g, d, int8):
    """The two new serving shapes: deepseek-7b's MHA (G = 1, D = 128) and
    stablelm-12b's D = 160 (G = 4).  Decode partials merge to JAX's
    flash_decode_jnp and its gather reference (1e-5); a prefill chunk's
    attention matches JAX's emulated kernel (1e-5) and its pages are
    bit-exact."""
    b, kvh, bs, w, c = 2, 2, 4, 6, 8
    nb = b * w + 1
    rng = np.random.default_rng(d + g)
    tables = (rng.permutation(nb - 1) + 1).reshape(b, w).astype(np.int32)
    n_valid = np.array([21, 9], np.int32)
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    (jk, tk), (jv, tv) = _pool(int8, 31, (nb, bs, kvh, d))
    want = jops.flash_decode_jnp(
        jnp.asarray(q), *_split(jk), *_split(jv), jnp.asarray(tables),
        jnp.asarray(n_valid), kv_splits=2)
    tkq, tks = _split(tk)
    tvq, tvs = _split(tv)
    got = tops.merge_splits(*tops.paged_attention_plain(
        _t(q), tkq, tvq, tks, tvs, _t(tables), _t(n_valid), kv_splits=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    q4 = q.reshape(b, 1, kvh * g, d)
    ref = (jref.dequant_attention_ref if int8 else jref.paged_attention_ref)(
        jnp.asarray(q4), jk, jv, jnp.asarray(tables), jnp.asarray(n_valid))
    out = tops.paged_attention(_t(q4), tk, tv, _t(tables), _t(n_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)

    qp = rng.standard_normal((b, c, kvh * g, d)).astype(np.float32)
    k_new = rng.standard_normal((b, c, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((b, c, kvh, d)).astype(np.float32)
    pos = np.array([8, 0], np.int32)
    n_tok = np.array([8, 5], np.int32)
    wm = np.array([1, 1], np.int32)
    jout, jk2, jv2 = jops.paged_prefill(
        jnp.asarray(qp), jnp.asarray(k_new), jnp.asarray(v_new), jk, jv,
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_tok),
        jnp.asarray(wm), backend="emulate")
    tout, tk2, tv2 = tops.paged_prefill(
        _t(qp), _t(k_new), _t(v_new), tk, tv, _t(tables), _t(pos),
        _t(n_tok), _t(wm))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for got_p, want_p in ((tk2, jk2), (tv2, jv2)):
        gq, _ = _split(got_p)
        wq, _ = _split(want_p)
        np.testing.assert_array_equal(gq.numpy()[1:], np.asarray(wq)[1:])
