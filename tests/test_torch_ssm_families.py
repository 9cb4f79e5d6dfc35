"""Port parity of the state-space families at reduced size: mamba2 (the
``ssm`` stack, 2 layers) and zamba2 (the ``hybrid`` stack, 4 layers in
two groups of 2, so two groups reuse one ``shared_attn`` block over
separate KV caches) against the JAX package: the parameters' crossing,
``model.prefill`` with its caches, ``decode_step`` and ``forward``, and
the path JAX serves them on, ``model.prefill`` then ``Engine.generate``.

Parameters are drawn by the JAX package and carried across by
``convert.params_from_jax``; the JAX side runs ``w8a8`` where the port
runs ``w8a8_kernel`` (bit-identical semantics, far cheaper than the
Pallas interpreter).  Greedy and sampled tokens must be identical, and
logits, states, keys and logprobs within 1e-4 (the families tests'
tolerance: the SSD and the attention sum f32 values in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import backend as jb
from repro.models import model as JM
from repro.serve import ContinuousEngine as JCE
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import model as TM
from repro_torch.serve import ContinuousEngine as TCE
from repro_torch.serve.engine import Engine as TEngine

ARCHS = {"mamba2-1.3b": 2, "zamba2-2.7b": 4}     # arch -> layers
PLANS = {"exact": (dict(default="exact"), dict(default="exact")),
         "w8a8": (dict(default="w8a8_kernel"), dict(default="w8a8"))}
TOL = 1e-4
MAX_LEN = 48
# Prompt lengths: two chunks of the reduced config's 8, and one shorter
# than a chunk (the scan takes min(chunk, S)).
PROMPT_LENS = (16, 6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _models(arch, plan_name, int8=False):
    jc = jcfg.reduced_config(arch, n_layers=ARCHS[arch])
    tc = tcfg.reduced_config(arch, n_layers=ARCHS[arch])
    if int8:
        jc = dataclasses.replace(jc, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    tkw, jkw = PLANS[plan_name]
    jplan, tplan = jb.DeploymentPlan(**jkw), tb.DeploymentPlan(**tkw)
    jp = JM.init(jax.random.PRNGKey(0), jc)
    if plan_name != "exact":
        jp = JM.freeze_params(jp, a_scale=0.05, plan=jplan)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jplan, tplan, jp, tp


def _prompts(s, b=2, seed=0):
    return np.random.default_rng(seed + s).integers(0, 256, (b, s)).astype(
        np.int32)


def _key(seed=3):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_jax(np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_carry_every_stack_key(arch):
    """``params_from_jax`` unstacks ``stack/blocks`` into per-layer dicts
    and carries every other key of ``stack``: zamba2's ``shared_attn``
    arrives whole, master and frozen."""
    for plan_name in PLANS:
        jc, tc, _, _, jp, tp = _models(arch, plan_name)
        jstack = jax.tree.map(np.asarray, jp["stack"])
        assert set(tp["stack"]) == set(jstack)
        assert len(tp["stack"]["blocks"]) == jc.n_layers
        if jc.arch_type != "hybrid":
            assert "shared_attn" not in tp["stack"]
            continue
        leaves = jax.tree_util.tree_flatten_with_path(
            jstack["shared_attn"])[0]
        assert leaves
        for path, leaf in leaves:
            t = tp["stack"]["shared_attn"]
            for p in path:
                t = t[p.key]
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_jax(arch, plan_name):
    """``model.prefill`` (the chunked scan with final states; the hybrid's
    shared block fills each group's KV cache) and two ``decode_step``s
    from the carried caches: logits, recurrent and conv states and the
    hybrid's keys within 1e-4; the full-sequence ``forward`` too."""
    jc, tc, jplan, tplan, jp, tp = _models(arch, plan_name)
    for s in PROMPT_LENS:
        toks = _prompts(s)
        jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                                max_len=MAX_LEN, mode=jplan)
        tl, tcache = TM.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc,
                                max_len=MAX_LEN, mode=tplan)
        _close(tl, jl)
        assert set(tcache) == set(jcache)
        for step in range(3):
            for name in ("ssm", "conv"):
                _close(tcache["ssm"][name], jcache["ssm"][name])
            if "kv" in jcache:
                assert tcache["kv"]["k"].shape[0] == jc.n_layers // 2
                _close(tcache["kv"]["k"], jcache["kv"]["k"])
                np.testing.assert_array_equal(tcache["kv"]["len"].numpy(),
                                              np.asarray(jcache["kv"]["len"]))
            if step == 2:
                break
            tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            jl, jcache = JM.decode_step(jp, {"tokens": jnp.asarray(tok)},
                                        jcache, jc, mode=jplan)
            tl, tcache = TM.decode_step(
                tp, {"tokens": torch.as_tensor(tok).long()}, tcache, tc,
                mode=tplan)
            _close(tl, jl)
        jh, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc, mode=jplan)
        th, _ = TM.forward(tp, {"tokens": torch.as_tensor(toks)}, tc,
                           mode=tplan)
        _close(th, jh)


@pytest.mark.parametrize("plan_name,int8,sampled", [
    ("exact", False, False), ("exact", False, True),
    ("w8a8", False, False), ("w8a8", True, True)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generate_matches_jax(arch, plan_name, int8, sampled):
    """Engine.generate, both decode loops, against JAX's one-dispatch
    loop: greedy or sampled at a key with request ids, then with stop
    tokens (two of the first run's tokens) and a pad token.  Tokens
    identical, logprobs within 1e-4.  (int8 turns the hybrid's shared
    KV caches to int8 codes; mamba2 has no KV cache.)"""
    jc, tc, jplan, tplan, jp, tp = _models(arch, plan_name, int8)
    je = JEngine(jp, jc, plan=jplan, max_len=MAX_LEN)
    te = TEngine(tp, tc, plan=tplan, max_len=MAX_LEN, device="cpu")
    jk, tk = _key()
    for s in PROMPT_LENS:
        toks = _prompts(s, seed=1)
        kw = dict(max_new_tokens=6, temperature=0.8 if sampled else 0.0,
                  request_ids=[5, 2])
        jr = je.generate({"tokens": jnp.asarray(toks)}, key=jk, **kw)
        stops = sorted({int(jr.tokens[0, 2]), int(jr.tokens[1, 4])})
        jstop = je.generate({"tokens": jnp.asarray(toks)}, key=jk,
                            stop_tokens=stops, pad_token=-1, **kw)
        for loop in ("scan", "eager"):
            for j, extra in ((jr, {}),
                             (jstop, dict(stop_tokens=stops, pad_token=-1))):
                tr = te.generate({"tokens": toks}, key=tk, decode_loop=loop,
                                 **kw, **extra)
                np.testing.assert_array_equal(tr.tokens.numpy(),
                                              np.asarray(j.tokens))
                _close(tr.logprobs.numpy(), j.logprobs)
                assert tr.steps == j.steps
                if j.done is not None:
                    np.testing.assert_array_equal(tr.done.numpy(),
                                                  np.asarray(j.done))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_continuous_refuses_as_jax(arch):
    """ssm and hybrid models are served by Engine.generate only: the
    continuous engine refuses them with the JAX package's message."""
    jc, tc, _, _, jp, tp = _models(arch, "exact")
    with pytest.raises(ValueError) as jerr:
        JCE(jp, jc)
    with pytest.raises(ValueError) as terr:
        TCE(tp, tc, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launcher_serves_each_arch(arch):
    """``python -m repro_torch.launch.serve --arch ...`` on the CPU: the
    static engine serves both; ``--continuous`` is refused."""
    from repro_torch.launch import serve as launch
    toks = launch.main(["--arch", arch, "--plan", "w8a8_kernel", "--device",
                        "cpu", "--batch", "2", "--tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    with pytest.raises(ValueError, match="dense-attention archs"):
        launch.main(["--arch", arch, "--continuous", "--plan",
                     "w8a8_kernel", "--device", "cpu", "--batch", "2"])
