"""Port parity of M-RoPE (qwen2-vl-72b at reduced size: 2 layers, d_model
64, sections (4, 2, 2) of head_dim/2 = 8) against the JAX package:
``rope_angles`` with sections, attention and the forward from ``embeds``
with [3, B, S] t/h/w positions and with positions left to their default,
``Engine.generate`` from embeds and from tokens, the launcher's text-only
static path, and the paged refusals.

Parameters are drawn by the JAX package and carried across; the JAX side
runs ``w8a8`` where the port runs ``w8a8_kernel``.  Inputs come from a
numpy seed.  Angles bit-exact, stack outputs and logits within 1e-5,
served logprobs within 1e-4 and tokens identical (as in
``tests/test_torch_encdec.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import backend as jb
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import ContinuousEngine as JCE
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import ContinuousEngine as TCE
from repro_torch.serve.engine import Engine as TEngine

ARCH = "qwen2-vl-72b"
PLANS = {"exact": (dict(default="exact"), dict(default="exact")),
         "w8a8": (dict(default="w8a8_kernel"), dict(default="w8a8"))}
TOL = 1e-5
LP_TOL = 1e-4
MAX_LEN = 40


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def models():
    jc = jcfg.reduced_config(ARCH)
    tc = tcfg.reduced_config(ARCH)
    master = JM.init(jax.random.PRNGKey(0), jc)
    out = {}
    for name, (tkw, jkw) in PLANS.items():
        jplan, tplan = jb.DeploymentPlan(**jkw), tb.DeploymentPlan(**tkw)
        jp = master if name == "exact" else JM.freeze_params(
            master, a_scale=0.05, plan=jplan)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc)
        out[name] = (jc, tc, jplan, tplan, jp, tp)
    return out


def _positions(b, n_text, rows, cols, n_after):
    """Qwen2-VL's [3, B, S] layout: text runs t = h = w = i; an image grid
    takes t = offset, h = offset + row, w = offset + col; the text after
    it resumes at offset + max(rows, cols)."""
    text = np.arange(n_text)
    grid = np.stack([np.full(rows * cols, n_text),
                     n_text + np.repeat(np.arange(rows), cols),
                     n_text + np.tile(np.arange(cols), rows)])
    after = n_text + max(rows, cols) + np.arange(n_after)
    pos = np.concatenate([np.stack([text] * 3), grid,
                          np.stack([after] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(
        np.int32).copy()


def _embeds(b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(
        np.float32)


def test_rope_angles_sections_bit_exact():
    """RoPE frequencies and M-RoPE angles bit for bit against the JAX
    package at every config's (head_dim, rope_theta), head_dim 128 at
    theta 1e6 included, and at the reduced head_dim: each section's
    frequency bands from its own axis of the [3, B, S] positions.  The
    asserts become ValueErrors."""
    pos = _positions(2, 5, 3, 4, 6)
    shapes = {(c.resolved_head_dim, c.rope_theta)
              for c in map(tcfg.get_config, tcfg.ARCH_IDS)}
    for hd, theta in sorted(shapes | {(16, 1e6)}):
        np.testing.assert_array_equal(
            TL._rope_freqs(hd, theta, torch.device("cpu")).numpy(),
            np.asarray(JL._rope_freqs(hd, theta)), err_msg=f"hd={hd}")
        want = np.asarray(JL.rope_angles(jnp.asarray(pos[0]), hd, theta))
        got = TL.rope_angles(torch.as_tensor(pos[0]).long(), hd,
                             theta).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"hd={hd}")
    for hd, sections in ((16, (4, 2, 2)), (128, (16, 24, 24))):
        want = np.asarray(JL.rope_angles(jnp.asarray(pos), hd, 1e6,
                                         sections))
        got = TL.rope_angles(torch.as_tensor(pos).long(), hd, 1e6,
                             sections).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="positions"):
        TL.rope_angles(torch.as_tensor(pos[0]).long(), 16, 1e6, (4, 2, 2))
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        TL.rope_angles(torch.as_tensor(pos).long(), 16, 1e6, (4, 2, 1))


@pytest.mark.parametrize("given", [True, False])
def test_attention_and_forward(models, given):
    """Attention and the forward from embeds, with image positions or
    with the default (arange(S) on every axis)."""
    jc, tc, _, _, jp, tp = models["exact"]
    pos = _positions(2, 3, 2, 3, 4)
    x = _embeds(2, pos.shape[2], 1)
    kw_j = dict(positions=jnp.asarray(pos)) if given else {}
    kw_t = dict(positions=torch.as_tensor(pos).long()) if given else {}
    blk = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"])["attn"]
    jy, _ = JA.attention(blk, jnp.asarray(x), jc, **kw_j)
    ty, _ = TA.attention(tp["stack"]["blocks"][0]["attn"],
                         torch.as_tensor(x), tc, **kw_t)
    _close(ty.numpy(), jy)
    batch_j, batch_t = {"embeds": jnp.asarray(x), **kw_j}, {
        "embeds": torch.as_tensor(x), **kw_t}
    jh, _ = JM.forward(jp, batch_j, jc)
    th, _ = TM.forward(tp, batch_t, tc)
    _close(th.numpy(), jh)
    # The positions are live: the image layout moves the output.
    if given:
        plain, _ = TA.attention(tp["stack"]["blocks"][0]["attn"],
                                torch.as_tensor(x), tc)
        assert (plain - ty).abs().max() > 1e-3


@pytest.mark.parametrize("plan_name", ["exact", "w8a8"])
def test_prefill_and_decode_from_embeds(models, plan_name):
    """``model.prefill`` from embeds with image positions into the dense
    cache, then decode steps at the cache's length on every axis."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    pos = _positions(2, 2, 2, 2, 3)
    x = _embeds(2, pos.shape[2], 2)
    jl, jcache = JM.prefill(jp, {"embeds": jnp.asarray(x),
                                 "positions": jnp.asarray(pos)}, jc,
                            max_len=MAX_LEN, mode=jplan)
    tl, tcache = TM.prefill(tp, {"embeds": torch.as_tensor(x),
                                 "positions": torch.as_tensor(pos).long()},
                            tc, max_len=MAX_LEN, mode=tplan)
    _close(tl.numpy(), jl)
    for tok in np.random.default_rng(3).integers(0, 256, (3, 2)):
        tok = tok.astype(np.int32)
        jl, jcache = JM.decode_step(jp, {"tokens": jnp.asarray(tok)[:, None]},
                                    jcache, jc, mode=jplan)
        tl, tcache = TM.decode_step(
            tp, {"tokens": torch.as_tensor(tok).long()[:, None]}, tcache, tc,
            mode=tplan)
        _close(tl.numpy(), jl)


def _key(seed=3):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_jax(np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("plan_name,source,sampled,stops", [
    ("exact", "embeds", False, True), ("w8a8", "embeds", True, False),
    ("w8a8", "embeds_default", False, False), ("exact", "tokens", True, True),
    ("w8a8", "tokens", False, False)])
def test_generate_identical_to_jax(models, plan_name, source, sampled,
                                   stops):
    """``Engine.generate`` from embeds with image positions, from embeds
    with the default positions, and from token prompts (bucketed, as in
    JAX): both loops of the port against JAX's loop."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    je = JEngine(jp, jc, plan=jplan, max_len=MAX_LEN)
    te = TEngine(tp, tc, plan=tplan, max_len=MAX_LEN, device="cpu")
    pos = _positions(3, 2, 3, 3, 2)
    if source == "tokens":
        batch = {"tokens": np.random.default_rng(6).integers(
            0, 256, (3, 9)).astype(np.int32)}
    else:
        batch = {"embeds": _embeds(3, pos.shape[2], 4)}
        if source == "embeds":
            batch["positions"] = pos
    jk, tk = _key()
    kw = dict(max_new_tokens=6, temperature=0.8 if sampled else 0.0)
    if stops:
        free = te.generate(batch, key=tk, **kw).tokens.numpy()
        kw.update(stop_tokens=[int(free[0, 1]), int(free[1, 2]),
                               int(free[2, 0])], pad_token=255)
    jr = je.generate({k: jnp.asarray(v) for k, v in batch.items()}, key=jk,
                     **kw)
    for loop in ("scan", "eager"):
        tr = te.generate(batch, key=tk, decode_loop=loop, **kw)
        np.testing.assert_array_equal(tr.tokens.numpy(),
                                      np.asarray(jr.tokens))
        _close(tr.logprobs.numpy(), jr.logprobs, LP_TOL)
        assert tr.steps == jr.steps


def test_launcher_serves_text_only():
    """The launcher's static path feeds ``PRNGKey(1)`` token prompts:
    qwen2-vl serves them text-only, as in JAX; ``--continuous`` is
    refused."""
    from repro_torch.launch import serve as launch
    toks = launch.main(["--arch", ARCH, "--plan", "w8a8_kernel", "--device",
                        "cpu", "--batch", "2", "--tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    with pytest.raises(ValueError, match="M-RoPE"):
        launch.main(["--arch", ARCH, "--continuous", "--device", "cpu"])


def test_paged_and_continuous_refuse_mrope(models):
    """A paged pool and the continuous engine refuse M-RoPE with the JAX
    package's messages."""
    jc, tc, _, _, jp, tp = models["exact"]
    with pytest.raises(ValueError) as jerr:
        JCE(jp, jc)
    with pytest.raises(ValueError) as terr:
        TCE(tp, tc, device="cpu")
    assert str(terr.value) == str(jerr.value)
    x = _embeds(1, 1, 5)
    shape = (3, 16, tc.n_kv_heads, tc.resolved_head_dim)
    blk = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"])["attn"]
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "block_tables": jnp.ones((1, 2), jnp.int32),
              "lens": jnp.asarray([3], jnp.int32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "block_tables": torch.ones(1, 2, dtype=torch.int32),
              "lens": torch.tensor([3], dtype=torch.int32)}
    with pytest.raises(AssertionError) as jerr:
        JA.attention(blk, jnp.asarray(x), jc, kv_cache=jcache)
    with pytest.raises(ValueError) as terr:
        TA.attention(tp["stack"]["blocks"][0]["attn"], torch.as_tensor(x),
                     tc, kv_cache=tcache)
    assert str(terr.value) == str(jerr.value)
