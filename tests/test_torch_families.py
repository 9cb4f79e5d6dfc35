"""Port parity of the decoder-only family at reduced size: granite-moe,
moonshot (MoE), h2o-danube (sliding window), deepseek (MHA) and
stablelm (GQA) against the JAX package, on the entry points each is
served through there.

Parameters are drawn by the JAX package and carried across; the JAX side
runs ``w8a8`` where the port runs ``w8a8_kernel`` (bit-identical
semantics; the Pallas interpreter is far slower on the CPU), both with
the default deploy plan's ``*router*`` rule (routers stay float).
Greedy tokens must be identical and prefill logits and logprobs within
1e-4 (``tests/test_torch_engine.py``'s tolerance: the attention and the
float linears sum f32 values in another order)."""
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
from repro.serve import Request as JRequest
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import model as TM
from repro_torch.serve import ContinuousEngine as TCE
from repro_torch.serve import Request as TRequest
from repro_torch.serve.engine import Engine as TEngine

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "h2o-danube-3-4b",
         "deepseek-7b", "stablelm-12b")
ROUTER = (("*router*", "exact"),)
# (port plan, JAX plan) keyword arguments by name.
PLANS = {"exact": (dict(default="exact"), dict(default="exact")),
         "w8a8": (dict(rules=ROUTER, default="w8a8_kernel"),
                  dict(rules=ROUTER, default="w8a8"))}
TOL = 1e-4
MAX_LEN = 64


def _models(arch, plan_name, int8=False):
    jc = jcfg.reduced_config(arch, n_layers=2)
    tc = tcfg.reduced_config(arch, n_layers=2)
    if int8:
        jc = dataclasses.replace(jc, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    tkw, jkw = PLANS[plan_name]
    jplan = jb.DeploymentPlan(**jkw)
    tplan = tb.DeploymentPlan(**tkw)
    jp = JM.init(jax.random.PRNGKey(0), jc)
    if plan_name != "exact":
        jp = JM.freeze_params(jp, a_scale=0.05, plan=jplan)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jplan, tplan, jp, tp


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch, plan_name):
    """Engine.generate, greedy: prompts of 13 tokens (past the reduced
    window of 8) and, for the MoE models, 40 (past 4E = 32 tokens, so
    capacity drops tokens in the prefill)."""
    jc, tc, jplan, tplan, jp, tp = _models(arch, plan_name,
                                           int8=arch == "deepseek-7b")
    je = JEngine(jp, jc, plan=jplan, max_len=MAX_LEN)
    te = TEngine(tp, tc, plan=tplan, max_len=MAX_LEN, device="cpu")
    lens = (13, 40) if jc.arch_type == "moe" else (13,)
    for s in lens:
        toks = np.random.default_rng(s).integers(0, 256, (2, s)).astype(
            np.int32)
        jl, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                           max_len=MAX_LEN, mode=jplan)
        tl, _ = TM.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc,
                           max_len=MAX_LEN, mode=tplan)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        jr = je.generate({"tokens": jnp.asarray(toks)}, max_new_tokens=6)
        tr = te.generate({"tokens": toks}, max_new_tokens=6)
        np.testing.assert_array_equal(tr.tokens.numpy(),
                                      np.asarray(jr.tokens))
        np.testing.assert_allclose(tr.logprobs.numpy(),
                                   np.asarray(jr.logprobs), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "h2o-danube-3-4b"])
def test_continuous_refuses_as_jax(arch):
    """MoE and windowed models are served by Engine.generate only: the
    continuous engine refuses them with the JAX package's message."""
    jc, tc, jplan, tplan, jp, tp = _models(arch, "exact")
    with pytest.raises(ValueError) as jerr:
        JCE(jp, jc)
    with pytest.raises(ValueError) as terr:
        TCE(tp, tc, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("arch", ["deepseek-7b", "stablelm-12b"])
def test_continuous_streams_match_jax(arch, chunked):
    """ContinuousEngine over an int8 paged pool with paged attention (G =
    1 for deepseek, 2 for stablelm at reduced size), chunked and blocking
    prefill: identical token streams, logprobs within 1e-4."""
    jc, tc, jplan, tplan, jp, tp = _models(arch, "w8a8", int8=True)
    jplan = dataclasses.replace(jplan, paged_attn=True)
    tplan = dataclasses.replace(tplan, paged_attn=True)
    rng = np.random.default_rng(3)
    specs = [dict(rid=i, prompt=rng.integers(0, 256, int(n)),
                  max_new=int(m), arrival_step=a)
             for i, (n, m, a) in enumerate(zip((9, 30, 17, 4), (5, 3, 7, 6),
                                               (0, 0, 2, 3)))]
    kw = dict(max_batch=3, kv_blocks=40, block_size=4, max_blocks_per_req=12,
              segment_len=4, paged_attn=True, chunked_prefill=chunked,
              prefill_chunk=8)
    jr = JCE(jp, jc, plan=jplan, **kw).run([JRequest(**s) for s in specs])
    te = TCE(tp, tc, plan=tplan, device="cpu", **kw)
    tr = te.run([TRequest(**s) for s in specs])
    assert te.allocator.free_blocks == te.allocator.capacity
    assert set(jr) == set(tr)
    for rid in jr:
        assert tr[rid].status.value == jr[rid].status.value == "ok"
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        np.testing.assert_allclose(tr[rid].logprobs, jr[rid].logprobs,
                                   rtol=TOL, atol=TOL)


def test_long_prompt_prefill_matches_jax():
    """A 2560-token prompt (past chunked_threshold 2048) through
    model.prefill into a dense cache: attend_chunked in both packages,
    logits within 1e-4, the cache's keys too, then one decode step."""
    jc, tc, jplan, tplan, jp, tp = _models("deepseek-7b", "exact")
    jc = dataclasses.replace(jc, n_layers=1)
    tc = dataclasses.replace(tc, n_layers=1)
    jp = dict(jp, stack={"blocks": jax.tree.map(lambda a: a[:1],
                                                jp["stack"]["blocks"])})
    tp = dict(tp, stack={"blocks": tp["stack"]["blocks"][:1]})
    s = 2560
    toks = np.random.default_rng(9).integers(0, 256, (1, s)).astype(np.int32)
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                            max_len=s + 4)
    tl, tcache = TM.prefill(tp, {"tokens": torch.as_tensor(toks)}, tc,
                            max_len=s + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tcache["kv"]["k"][:, :, :s].numpy(),
                               np.asarray(jcache["kv"]["k"])[:, :, :s],
                               rtol=TOL, atol=TOL)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    jl, _ = JM.decode_step(jp, {"tokens": jnp.asarray(tok)[:, None]},
                           jcache, jc)
    tl, _ = TM.decode_step(tp, {"tokens": torch.as_tensor(tok).long()[:,
                                                                      None]},
                           tcache, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b", "h2o-danube-3-4b",
                                  "deepseek-7b", "stablelm-12b"])
def test_launcher_serves_each_arch(arch):
    """``python -m repro_torch.launch.serve --arch ...`` on the CPU: the
    static engine for every arch, the continuous engine for the dense
    ones without a window; the others are refused."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import RequestStatus
    toks = launch.main(["--arch", arch, "--plan", "w8a8_kernel", "--device",
                        "cpu", "--batch", "2", "--tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    cont = ["--arch", arch, "--continuous", "--paged-attn", "--plan",
            "w8a8_kernel", "--device", "cpu", "--batch", "2", "--tokens",
            "3"]
    cfg = tcfg.get_config(arch)
    if cfg.arch_type == "moe" or cfg.sliding_window is not None:
        with pytest.raises(ValueError, match="sliding windows"):
            launch.main(cont)
        return
    res = launch.main(cont)
    assert all(r.status is RequestStatus.OK and len(r.tokens) == 3
               for r in res.values())
