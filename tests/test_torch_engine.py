"""Port parity of the static serving engine: ``Engine.generate`` over
dense KV caches against the JAX package's, and ``model.prefill`` /
``decode_step`` over the dense cache.

Parameters are drawn once by the JAX package and carried across; on the
JAX side the ``w8a8`` oracle stands in for ``w8a8_kernel`` (bit-identical
without a bias, far cheaper than the Pallas interpreter).  Tokens must be
identical, greedy and sampled at a fixed key (the port's sampler is
``jax.random``'s bit for bit); logprobs within rtol=atol=1e-4, the
tolerance of ``test_torch_serve.py`` (the attention sums f32 values in
another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import backend as jb
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import model as TM
from repro_torch.serve.engine import Engine as TEngine

MAX_LEN = 48
# (port plan, JAX plan) by name.
PLANS = {
    "exact": (dict(default="exact"), dict(default="exact")),
    "w8a8_kernel": (dict(default="w8a8_kernel"), dict(default="w8a8")),
    "residency": (dict(default="w8a8_kernel", residency=True),
                  dict(default="w8a8", residency=True)),
}


@pytest.fixture(scope="module")
def master():
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg))


def _engines(master, plan_name, int8, **kw):
    cfg = jcfg.reduced_config("qwen3-8b", n_layers=2)
    tc = tcfg.reduced_config("qwen3-8b", n_layers=2)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    tplan_kw, jplan_kw = PLANS[plan_name]
    jplan, tplan = jb.DeploymentPlan(**jplan_kw), tb.DeploymentPlan(
        **tplan_kw)
    jp = jax.tree.map(jnp.asarray, master)
    if plan_name != "exact":
        jp = JM.freeze_params(jp, a_scale=0.05, plan=jplan)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
    kw = dict(dict(max_len=MAX_LEN), **kw)
    return (JEngine(jp, cfg, plan=jplan, **kw),
            TEngine(tp, tc, plan=tplan, device="cpu", **kw))


def _prompts(b=3, s=13, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _key(seed=3):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_jax(np.asarray(jax.random.key_data(k)))


def _assert_same(jr, tr, logprob_tol=1e-4):
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=logprob_tol, atol=logprob_tol)
    assert tr.steps == jr.steps
    if jr.done is None:
        assert tr.done is None
    else:
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))


@pytest.mark.parametrize("plan_name,int8,sampled", [
    ("exact", False, False), ("exact", True, True),
    ("w8a8_kernel", True, False), ("w8a8_kernel", False, False),
    ("w8a8_kernel", True, True), ("w8a8_kernel", False, True),
    ("residency", True, False), ("residency", False, True)])
def test_generate_identical_to_jax(master, plan_name, int8, sampled):
    """Both decode loops of the port against JAX's one-dispatch loop."""
    je, te = _engines(master, plan_name, int8)
    toks = _prompts()
    jk, tk = _key()
    kw = dict(max_new_tokens=7, temperature=0.8 if sampled else 0.0,
              request_ids=[4, 0, 9])
    jr = je.generate({"tokens": jnp.asarray(toks)}, key=jk, **kw)
    for loop in ("scan", "eager"):
        tr = te.generate({"tokens": toks}, key=tk, decode_loop=loop, **kw)
        _assert_same(jr, tr)
    assert te.last_dispatch_count == 2 + 7


def test_scan_equals_eager_with_stops(master):
    """The two loops agree bit for bit, with stop tokens and sampling;
    the scan loop is one dispatch."""
    _, te = _engines(master, "w8a8_kernel", True)
    _, tk = _key(11)
    toks = _prompts(4, 9, seed=2)
    base = te.generate({"tokens": toks}, max_new_tokens=8, temperature=0.7,
                       key=tk)
    stops = sorted({int(base.tokens[0, 2]), int(base.tokens[3, 4])})
    out = {}
    for loop in ("scan", "eager"):
        out[loop] = te.generate({"tokens": toks}, max_new_tokens=8,
                                temperature=0.7, key=tk, stop_tokens=stops,
                                pad_token=-1, decode_loop=loop)
        assert te.last_dispatch_count == (1 if loop == "scan"
                                          else 2 + out[loop].steps)
    assert torch.equal(out["scan"].tokens, out["eager"].tokens)
    assert torch.equal(out["scan"].logprobs, out["eager"].logprobs)
    assert torch.equal(out["scan"].done, out["eager"].done)
    assert out["scan"].steps == out["eager"].steps
    assert bool(out["scan"].done[0]) and bool(out["scan"].done[3])


@pytest.mark.parametrize("all_stop", [False, True])
def test_stop_tokens_match_jax(master, all_stop):
    """Stop tokens: done rows emit the pad with logprob 0; when every row
    stops the loop exits early with JAX's step count."""
    je, te = _engines(master, "exact", False)
    toks = _prompts(3, 11, seed=7)
    free = te.generate({"tokens": toks}, max_new_tokens=9)
    t = free.tokens.numpy()
    stops = ([int(t[0, 1]), int(t[1, 2]), int(t[2, 0])] if all_stop
             else [int(t[1, 3])])
    kw = dict(max_new_tokens=9, stop_tokens=stops, pad_token=255)
    jr = je.generate({"tokens": jnp.asarray(toks)}, **kw)
    tr = te.generate({"tokens": toks}, **kw)
    _assert_same(jr, tr)
    assert bool(tr.done[1])
    if all_stop:
        assert bool(tr.done.all()) and tr.steps < 9
    pads = tr.tokens.numpy() == 255
    assert pads.any()
    assert np.all(tr.logprobs.numpy()[pads] == 0.0)


def test_prebucketed_length_and_no_bucket(master):
    """A pre-bucketed batch (tokens right-padded, true length given) and
    an engine that does not bucket (seq_bucket=1) give the bucketed
    engine's tokens, in both packages."""
    toks = _prompts(2, 10, seed=9)
    padded = np.pad(toks, ((0, 0), (0, 6)))
    results = []
    for seq_bucket in (32, 1):
        je, te = _engines(master, "w8a8_kernel", True,
                          seq_bucket=seq_bucket)
        for batch_t, batch_j in (
                ({"tokens": toks}, {"tokens": jnp.asarray(toks)}),
                ({"tokens": padded, "length": 10},
                 {"tokens": jnp.asarray(padded),
                  "length": jnp.asarray(10, jnp.int32)})):
            jr = je.generate(batch_j, max_new_tokens=6)
            tr = te.generate(batch_t, max_new_tokens=6)
            _assert_same(jr, tr)
            results.append(tr.tokens)
    for r in results[1:]:
        assert torch.equal(r, results[0])
    assert te.bucket({"tokens": torch.zeros(1, 5, dtype=torch.long)}
                     )["tokens"].shape == (1, 5)


def test_generate_rejects_overflow(master):
    _, te = _engines(master, "exact", False)
    with pytest.raises(ValueError, match="exceeds max_len"):
        te.generate({"tokens": _prompts(1, 40)}, max_new_tokens=9)
    with pytest.raises(ValueError, match="decode_loop"):
        te.generate({"tokens": _prompts(1, 4)}, decode_loop="while")


@pytest.mark.parametrize("plan_name,int8", [
    ("exact", False), ("exact", True), ("w8a8_kernel", True),
    ("residency", False)])
def test_prefill_decode_logits_dense_cache(master, plan_name, int8):
    """model.prefill (bucketed, with length) and decode_step over the
    dense cache, logits against JAX's; the cache rewinds past the pads."""
    je, te = _engines(master, plan_name, int8)
    toks = np.pad(_prompts(2, 11, seed=4), ((0, 0), (0, 5)))
    jl, jc = JM.prefill(je.params, {"tokens": jnp.asarray(toks),
                                    "length": jnp.asarray(11, jnp.int32)},
                        je.cfg, max_len=MAX_LEN, mode=je.plan)
    tl, tc = TM.prefill(te.params, {"tokens": torch.as_tensor(toks).long(),
                                    "length": 11},
                        te.cfg, max_len=MAX_LEN, mode=te.plan)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert tc["kv"]["len"].tolist() == [11] * te.cfg.n_layers
    if int8:
        assert tc["kv"]["k"].dtype == torch.int8
        assert tc["kv"]["k_scale"].dtype == torch.bfloat16
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(je.params,
                                {"tokens": jnp.asarray(tok)[:, None]}, jc,
                                je.cfg, mode=je.plan)
        tl, tc = TM.decode_step(te.params,
                                {"tokens": torch.as_tensor(tok).long()[:,
                                                                       None]},
                                tc, te.cfg, mode=te.plan)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl[:, -1].argmax(-1).numpy())
    assert tc["kv"]["len"].tolist() == [14] * te.cfg.n_layers
    if int8:
        np.testing.assert_array_equal(
            tc["kv"]["k"][:, :, :14].numpy(),
            np.asarray(jc["kv"]["k"])[:, :, :14])


def test_unported_dense_shapes_raise():
    """Sliding windows get a ring cache of min(max_len, window) positions
    and prompts over 2048 tokens go through attend_chunked, which keeps
    the JAX package's requirement of whole 512-token query chunks (a
    2049-token prompt raises where JAX asserts).  An encdec stack's
    caches need the encoder output's shape: ``init_caches`` without
    ``enc_out`` raises where JAX asserts."""
    from repro_torch.models import transformer
    tc = tcfg.reduced_config("qwen3-8b", n_layers=1)
    params = TM.init(tc, torch.Generator().manual_seed(0), device="cpu")
    ring = transformer.init_caches(dataclasses.replace(tc, sliding_window=8),
                                   1, 16, device="cpu")
    assert ring["kv"]["k"].shape[2] == 8
    toks = torch.zeros(1, 2049, dtype=torch.long)
    with pytest.raises(ValueError, match="q_chunk"):
        TM.prefill(params, {"tokens": toks}, tc, max_len=2056)
    with pytest.raises(ValueError, match="enc_out"):
        transformer.init_caches(tcfg.reduced_config("whisper-large-v3"),
                                1, 16, device="cpu")


# Past max_len: (arch, layers, max_len, prompt length).  mamba2's state is
# constant-size; h2o-danube's reduced window of 8 keeps a ring of 8 slots
# inside a max_len of 16.  Prompts are whole SSD chunks (8) for mamba2.
PAST_MAX_LEN = {"mamba2-1.3b": (2, 16, 16), "h2o-danube-3-4b": (2, 16, 12)}


def _family_engines(arch, layers, max_len, sliding_window=None):
    jc = jcfg.reduced_config(arch, n_layers=layers)
    tc = tcfg.reduced_config(arch, n_layers=layers)
    if sliding_window is not None:
        jc = dataclasses.replace(jc, sliding_window=sliding_window)
        tc = dataclasses.replace(tc, sliding_window=sliding_window)
    jplan, tplan = jb.DeploymentPlan(default="w8a8"), tb.DeploymentPlan(
        default="w8a8_kernel")
    jp = JM.freeze_params(JM.init(jax.random.PRNGKey(0), jc), a_scale=0.05,
                          plan=jplan)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return (JEngine(jp, jc, plan=jplan, max_len=max_len),
            TEngine(tp, tc, plan=tplan, max_len=max_len, device="cpu"))


@pytest.mark.parametrize("arch", sorted(PAST_MAX_LEN))
def test_generate_past_max_len_matches_jax(arch):
    """An ssm stack and a ring of window <= max_len hold no cache that
    max_len bounds: both decode past max_len with JAX's tokens, greedy
    and sampled, in both loops."""
    max_len, s = PAST_MAX_LEN[arch][1:]
    je, te = _family_engines(arch, PAST_MAX_LEN[arch][0], max_len)
    toks = _prompts(2, s, seed=6)
    jk, tk = _key(5)
    new = max_len - s + 6
    for temperature in (0.0, 0.8):
        kw = dict(max_new_tokens=new, temperature=temperature)
        jr = je.generate({"tokens": jnp.asarray(toks)}, key=jk, **kw)
        for loop in ("scan", "eager"):
            _assert_same(jr, te.generate({"tokens": toks}, key=tk,
                                         decode_loop=loop, **kw))


@pytest.mark.parametrize("arch,layers,window", [
    ("qwen3-8b", 2, None), ("zamba2-2.7b", 2, None),
    ("h2o-danube-3-4b", 2, 24)])
def test_generate_past_max_len_refused(arch, layers, window):
    """A dense KV cache sized by max_len (a dense stack, hybrid's shared
    attention block, a window longer than max_len) still refuses a
    request past it."""
    _, te = _family_engines(arch, layers, 16, sliding_window=window)
    with pytest.raises(ValueError, match="exceeds max_len"):
        te.generate({"tokens": _prompts(1, 8)}, max_new_tokens=9)
