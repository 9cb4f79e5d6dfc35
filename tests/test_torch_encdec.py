"""Port parity of the encoder-decoder family (whisper-large-v3 at reduced
size: 2 encoder and 2 decoder layers, d_model 64, the gelu MLP) against
the JAX package: the gelu MLP and LayerNorm, every attention mode of the
family (bidirectional, cross-attention projecting the encoder output,
cross-attention over precomputed K/V; each below and above a lowered
``chunked_threshold``), the encoder, the cross K/V, the forward, the
prefill with its caches and teacher-forced decode, and
``Engine.generate``.

Parameters are drawn by the JAX package and carried across by
``convert.params_from_jax``; the JAX side runs ``w8a8`` where the port
runs ``w8a8_kernel`` (bit-identical semantics, far cheaper than the
Pallas interpreter).  Inputs come from a numpy seed.  Layers within 1e-6,
stack outputs and logits within 1e-5 (f32 sums in another order), served
logprobs within 1e-4 (``tests/test_torch_engine.py``'s tolerance) and
tokens identical."""
import dataclasses

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
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JCE
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.core import backend as tb
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import ContinuousEngine as TCE
from repro_torch.serve.engine import Engine as TEngine

ARCH = "whisper-large-v3"
# (port plan, JAX plan) keyword arguments by name.
PLANS = {"exact": (dict(default="exact"), dict(default="exact")),
         "w8a8": (dict(default="w8a8_kernel"), dict(default="w8a8")),
         "residency": (dict(default="w8a8_kernel", residency=True),
                       dict(default="w8a8", residency=True))}
TOL = 1e-5
LP_TOL = 1e-4
S_ENC = 20
MAX_LEN = 32


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def models():
    """Per plan name: (JAX cfg, port cfg, JAX plan, port plan, JAX params,
    port params); residency shares the w8a8 weights."""
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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(b=2, s=6, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "frames": _rand((b, S_ENC, 64), seed + 1)}


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: (torch.as_tensor(v).long() if v.dtype == np.int32
                else torch.as_tensor(v)) for k, v in batch.items()}


def test_params_carry_encoder_and_decoder(models):
    """``params_from_jax`` unstacks ``stack/encoder`` by n_enc_layers and
    ``stack/decoder`` by n_layers, and carries ``enc_final_norm``, master
    and frozen."""
    for name in ("exact", "w8a8"):
        jc, tc, _, _, jp, tp = models[name]
        assert set(tp) == {"embed", "stack", "final_norm", "lm_head",
                           "enc_final_norm"}
        assert set(tp["stack"]) == {"encoder", "decoder"}
        assert len(tp["stack"]["encoder"]) == tc.n_enc_layers
        assert len(tp["stack"]["decoder"]) == tc.n_layers
        assert {"xattn", "xattn_norm"} <= set(tp["stack"]["decoder"][1])
        leaf = "w_q" if name == "w8a8" else "w"
        np.testing.assert_array_equal(
            tp["stack"]["decoder"][1]["xattn"]["k"][leaf].numpy(),
            np.asarray(jp["stack"]["decoder"]["xattn"]["k"][leaf][1]))
        np.testing.assert_array_equal(
            tp["stack"]["encoder"][1]["mlp"]["in"][leaf].numpy(),
            np.asarray(jp["stack"]["encoder"]["mlp"]["in"][leaf][1]))
    # The port's own init builds the same tree.
    own = TM.init(models["exact"][1], torch.Generator().manual_seed(0),
                  device="cpu")
    assert set(own) == set(models["exact"][5])
    assert set(own["stack"]["decoder"][0]) == set(
        models["exact"][5]["stack"]["decoder"][0])


def test_gelu_mlp_and_layernorm(models):
    """The gelu MLP (tanh form, f32, JAX's ``jax.nn.gelu`` default) and
    LayerNorm, which no JAX model calls."""
    _, _, _, _, jp, tp = models["exact"]
    x = _rand((2, 7, 64), 3)
    jy = JL.mlp(_layer(jp["stack"]["encoder"])["mlp"], jnp.asarray(x),
                "gelu")
    ty = TL.mlp(tp["stack"]["encoder"][0]["mlp"], torch.as_tensor(x), "gelu")
    _close(ty.numpy(), jy, 1e-6)
    p = {"scale": _rand((64,), 4), "bias": _rand((64,), 5)}
    jn = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x))
    tn = TL.layernorm({k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x))
    _close(tn.numpy(), jn, 1e-6)
    assert set(TL.init_layernorm(64)) == set(JL.init_layernorm(64))


@pytest.mark.parametrize("kind", ["bidirectional", "xattn_kv",
                                  "xattn_cache", "xattn_cache_prefill"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("plan_name", ["exact", "residency"])
def test_attention_modes(models, kind, chunked, plan_name, monkeypatch):
    """Every attention mode of the family, through attend_full /
    attend_decode and, above a lowered threshold, attend_chunked.  Under
    int8 residency only self-attention shares one conversion of x across
    q/k/v: cross-attention's q and k/v read different sources."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    hd, kvh = tc.resolved_head_dim, tc.n_kv_heads
    # attend_chunked's self-attention takes whole 512-token query chunks.
    s = {"bidirectional": 512 if chunked else 12, "xattn_kv": 12,
         "xattn_cache": 1, "xattn_cache_prefill": 6}[kind]
    threshold = (256 if kind == "bidirectional" else 8) if chunked else 2048
    x = _rand((2, s, 64), 7 + s)
    if kind == "bidirectional":
        jblk, tblk = _layer(jp["stack"]["encoder"])["attn"], \
            tp["stack"]["encoder"][0]["attn"]
        jkw, tkw = dict(causal=False), dict(causal=False)
    elif kind == "xattn_kv":
        enc = _rand((2, S_ENC, 64), 8)
        jblk, tblk = _layer(jp["stack"]["decoder"])["xattn"], \
            tp["stack"]["decoder"][0]["xattn"]
        jkw = dict(xattn_kv=jnp.asarray(enc))
        tkw = dict(xattn_kv=torch.as_tensor(enc))
    else:
        k, v = _rand((2, S_ENC, kvh, hd), 9), _rand((2, S_ENC, kvh, hd), 10)
        jblk, tblk = _layer(jp["stack"]["decoder"])["xattn"], \
            tp["stack"]["decoder"][0]["xattn"]
        jkw = dict(xattn_cache={"k": jnp.asarray(k), "v": jnp.asarray(v)})
        tkw = dict(xattn_cache={"k": torch.as_tensor(k),
                                "v": torch.as_tensor(v)})
    shared = []
    real = tb.shared_quant
    monkeypatch.setattr(tb, "shared_quant",
                        lambda ps, x: shared.append(1) or real(ps, x))
    jy, _ = JA.attention(jblk, jnp.asarray(x), jc, mode=jplan,
                         chunked_threshold=threshold, **jkw)
    ty, _ = TA.attention(tblk, torch.as_tensor(x), tc, mode=tplan,
                         chunked_threshold=threshold, **tkw)
    _close(ty.numpy(), jy)
    assert len(shared) == (plan_name == "residency"
                           and kind == "bidirectional")


@pytest.mark.parametrize("plan_name", ["exact", "w8a8"])
def test_encoder_cross_kv_and_forward(models, plan_name):
    """``apply_encoder``, ``precompute_cross_kv`` and ``forward`` (the
    decoder cross-attending the final-normed encoder output)."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    batch = _batch(s=9)
    jenc = JT.apply_encoder(jp["stack"], jnp.asarray(batch["frames"]), jc,
                            mode=jplan)
    tenc = TT.apply_encoder(tp["stack"], torch.as_tensor(batch["frames"]),
                            tc, mode=tplan)
    _close(tenc.numpy(), jenc)
    jk, jv = JT.precompute_cross_kv(jp["stack"], jenc, jc, mode=jplan)
    tk, tv = TT.precompute_cross_kv(tp["stack"], torch.as_tensor(
        np.array(jenc)), tc, mode=tplan)
    assert tuple(tk.shape) == (tc.n_layers, 2, S_ENC, tc.n_kv_heads,
                               tc.resolved_head_dim)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    jh, _ = JM.forward(jp, _jbatch(batch), jc, mode=jplan)
    th, _ = TM.forward(tp, _tbatch(batch), tc, mode=tplan)
    _close(th.numpy(), jh)


@pytest.mark.parametrize("plan_name,int8", [("exact", False),
                                            ("w8a8", True)])
def test_prefill_and_teacher_forced_decode(models, plan_name, int8):
    """``model.prefill`` (encoder, cross K/V once, the decoder over its
    dense self-attention cache) and 4 decode steps fed JAX's tokens;
    cross K/V stay in the model dtype under an int8 KV cache."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    if int8:
        jc = dataclasses.replace(jc, kv_cache_dtype="int8")
        tc = dataclasses.replace(tc, kv_cache_dtype="int8")
    batch = _batch(s=7, seed=2)
    jl, jcache = JM.prefill(jp, _jbatch(batch), jc, max_len=MAX_LEN,
                            mode=jplan)
    tl, tcache = TM.prefill(tp, _tbatch(batch), tc, max_len=MAX_LEN,
                            mode=tplan)
    _close(tl.numpy(), jl)
    assert tcache["cross_k"].dtype == torch.float32
    assert tcache["kv"]["k"].dtype == (torch.int8 if int8 else torch.float32)
    _close(tcache["cross_v"].numpy(), jcache["cross_v"])
    assert tcache["kv"]["len"].tolist() == [7] * tc.n_layers
    toks = np.random.default_rng(4).integers(0, 256, (4, 2)).astype(np.int32)
    for tok in toks:
        jl, jcache = JM.decode_step(jp, {"tokens": jnp.asarray(tok)[:, None]},
                                    jcache, jc, mode=jplan)
        tl, tcache = TM.decode_step(
            tp, {"tokens": torch.as_tensor(tok).long()[:, None]}, tcache, tc,
            mode=tplan)
        _close(tl.numpy(), jl)
    assert tcache["kv"]["len"].tolist() == [11] * tc.n_layers


def _key(seed=3):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_jax(np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("plan_name,sampled,stops", [
    ("exact", False, True), ("exact", True, False),
    ("w8a8", False, False), ("w8a8", True, True)])
def test_generate_identical_to_jax(models, plan_name, sampled, stops):
    """``Engine.generate`` from frames + decoder prompts: both loops of
    the port against JAX's one-dispatch loop, greedy and sampled at one
    key, with and without stop tokens."""
    jc, tc, jplan, tplan, jp, tp = models[plan_name]
    je = JEngine(jp, jc, plan=jplan, max_len=MAX_LEN)
    te = TEngine(tp, tc, plan=tplan, max_len=MAX_LEN, device="cpu")
    batch = _batch(b=3, s=4, seed=5)
    jk, tk = _key()
    kw = dict(max_new_tokens=7, temperature=0.8 if sampled else 0.0,
              request_ids=[4, 0, 9])
    if stops:
        free = te.generate(batch, key=tk, **kw).tokens.numpy()
        kw.update(stop_tokens=[int(free[0, 1]), int(free[2, 3])],
                  pad_token=255)
    jr = je.generate(_jbatch(batch), key=jk, **kw)
    for loop in ("scan", "eager"):
        tr = te.generate(batch, key=tk, decode_loop=loop, **kw)
        np.testing.assert_array_equal(tr.tokens.numpy(),
                                      np.asarray(jr.tokens))
        _close(tr.logprobs.numpy(), jr.logprobs, LP_TOL)
        assert tr.steps == jr.steps
        if stops:
            np.testing.assert_array_equal(tr.done.numpy(),
                                          np.asarray(jr.done))


def test_continuous_engine_and_launcher_refuse(models):
    """The continuous engine refuses encdec with the JAX package's
    message; the launcher's static path feeds token prompts only, so
    whisper raises naming the missing ``frames`` (JAX's fails reading
    them)."""
    jc, tc, _, _, jp, tp = models["exact"]
    with pytest.raises(ValueError) as jerr:
        JCE(jp, jc)
    with pytest.raises(ValueError) as terr:
        TCE(tp, tc, device="cpu")
    assert str(terr.value) == str(jerr.value)
    from repro_torch.launch import serve as launch
    with pytest.raises(ValueError, match="frames"):
        launch.main(["--arch", ARCH, "--plan", "w8a8_kernel", "--device",
                     "cpu", "--batch", "2", "--tokens", "3"])
    with pytest.raises(ValueError, match="dense-attention archs"):
        launch.main(["--arch", ARCH, "--continuous", "--device", "cpu"])
