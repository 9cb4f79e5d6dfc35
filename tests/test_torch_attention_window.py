"""Port parity of long and windowed attention: ``attend_chunked`` (the
double-chunked online softmax of prompts past ``chunked_threshold``), the
sliding-window ring cache of ``Engine.generate`` and ``attention()``'s
routing past the threshold, against the JAX package on identical
numpy-seeded inputs.

Tolerance 2e-5 on f32 attention outputs (the JAX package's own
chunked-vs-full test allows rtol 2e-4, atol 2e-5; here both sides run the
same loops and differ only in einsum summation order) and 1e-4 on
logits through a model (``tests/test_torch_engine.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

TOL = 2e-5


def _qkv(b=2, s=64, h=4, kvh=2, d=16, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = sk or s
    return tuple(rng.normal(0, 1, shape).astype(np.float32) for shape in
                 ((b, s, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    return got


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(16, 16), (32, 16), (16, 64)])
def test_chunked_matches_jax(causal, q_chunk, kv_chunk):
    got = _both(JA.attend_chunked, TA.attend_chunked, _qkv(), causal=causal,
                q_chunk=q_chunk, kv_chunk=kv_chunk)
    full = TA.attend_full(*(torch.as_tensor(a) for a in _qkv()),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                               atol=TOL)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_chunked_window_matches_jax(window):
    """The trailing band: each 16-query chunk reads ceil((window + 16) /
    16) KV chunks; equal to JAX's and to the windowed full attention."""
    got = _both(JA.attend_chunked, TA.attend_chunked, _qkv(seed=1),
                causal=True, window=window, q_chunk=16, kv_chunk=16)
    _both(JA.attend_full, TA.attend_full, _qkv(seed=1), causal=True,
          window=window)
    full = TA.attend_full(*(torch.as_tensor(a) for a in _qkv(seed=1)),
                          causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                               atol=TOL)


def test_chunked_cross_lengths_matches_jax():
    _both(JA.attend_chunked, TA.attend_chunked, _qkv(s=32, sk=96, seed=2),
          causal=False, q_chunk=16, kv_chunk=32)


def test_full_q_offset_matches_jax():
    _both(JA.attend_full, TA.attend_full, _qkv(s=8, sk=24, seed=3),
          causal=True, window=12, q_offset=16)


def test_chunked_needs_whole_query_chunks():
    """JAX asserts S % q_chunk == 0; the port raises there too (no
    padding rule of its own)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(s=40))
    with pytest.raises(ValueError, match="q_chunk"):
        TA.attend_chunked(q, k, v, causal=True, q_chunk=16)


def _model(arch, **over):
    jc = dataclasses.replace(jcfg.reduced_config(arch, n_layers=2), **over)
    tc = dataclasses.replace(tcfg.reduced_config(arch, n_layers=2), **over)
    master = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jc))
    return jc, tc, jax.tree.map(jnp.asarray, master), \
        convert.params_from_jax(master, tc)


@pytest.mark.parametrize("prompt", [5, 13, 21])
def test_ring_cache_prefill_and_decode_match_jax(prompt):
    """Reduced h2o-danube-3-4b (window 8): the ring holds min(max_len, 8)
    positions in the model dtype even for an int8 config; a prompt longer
    than the window wraps it at prefill, decode steps wrap it further.
    Logits, the ring's contents and ``len`` equal JAX's."""
    jc, tc, jp, tp = _model("h2o-danube-3-4b", kv_cache_dtype="int8")
    caches = TT.init_caches(tc, 1, 40, torch.float32)
    assert tuple(caches["kv"]["k"].shape[1:3]) == (1, 8)
    assert caches["kv"]["k"].dtype == torch.float32
    assert "k_scale" not in caches["kv"]
    toks = np.random.default_rng(prompt).integers(0, 256, (1, prompt))
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                            max_len=40)
    tl, tcache = TM.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc,
                            max_len=40)
    for step in range(12):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache["kv"][name].numpy(),
                                       np.asarray(jcache["kv"][name]),
                                       rtol=1e-4, atol=1e-4)
        assert tcache["kv"]["len"].tolist() == \
            np.asarray(jcache["kv"]["len"]).tolist()
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        assert tok[0] == int(tl[:, -1].argmax(-1)[0])
        jl, jcache = JM.decode_step(jp, {"tokens": jnp.asarray(tok)[:, None]},
                                    jcache, jc)
        tl, tcache = TM.decode_step(
            tp, {"tokens": torch.as_tensor(tok).long()[:, None]}, tcache, tc)


def test_band_mask_on_a_longer_windowed_cache():
    """A windowed cache longer than the window is not a ring: decode takes
    the band mask (JAX attention.py's non-ring branch)."""
    jc, tc, jp, tp = _model("h2o-danube-3-4b")
    lp = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"]["attn"])
    tlp = tp["stack"]["blocks"][0]["attn"]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, 1, 64)).astype(np.float32)
    kc = rng.normal(0, 1, (1, 32, 2, 16)).astype(np.float32)
    vc = rng.normal(0, 1, (1, 32, 2, 16)).astype(np.float32)
    jy, _ = JA.attention(lp, jnp.asarray(x), jc, kv_cache={
        "k": jnp.asarray(kc), "v": jnp.asarray(vc),
        "len": jnp.asarray(20, jnp.int32)})
    tcache = {"k": torch.as_tensor(kc).clone(),
              "v": torch.as_tensor(vc).clone(),
              "len": torch.tensor(20, dtype=torch.int32)}
    ty, _ = TA.attention(tlp, torch.as_tensor(x), tc, kv_cache=tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    assert int(tcache["len"]) == 21


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "deepseek-7b"])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_past_threshold_matches_jax(arch, cached):
    """attention() routes S > chunked_threshold through attend_chunked
    (512 / 1024 chunks) with the window band, with and without a dense
    cache to fill."""
    jc, tc, jp, tp = _model(arch)
    lp = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"]["attn"])
    tlp = tp["stack"]["blocks"][0]["attn"]
    s = 1024
    x = np.random.default_rng(5).normal(0, 1, (1, s, 64)).astype(
        np.float32)
    jkw, tkw = {}, {}
    if cached:
        jcache = jax.tree.map(lambda a: a[0], JM.transformer.init_caches(
            jc, 1, s + 8, jnp.float32)["kv"])
        tcache = {k: v[0] for k, v in TT.init_caches(
            tc, 1, s + 8, torch.float32)["kv"].items()}
        jkw, tkw = {"kv_cache": jcache}, {"kv_cache": tcache}
    jy, jnew = JA.attention(lp, jnp.asarray(x), jc, chunked_threshold=512,
                            **jkw)
    ty, _ = TA.attention(tlp, torch.as_tensor(x), tc, chunked_threshold=512,
                         **tkw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    if cached:
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jnew["k"]), rtol=1e-4,
                                   atol=1e-4)
        assert int(tcache["len"]) == int(jnew["len"]) == s
