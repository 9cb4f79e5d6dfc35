"""Port parity of the training step against the JAX package: the
chunked LM loss, and three train steps of qwen3-8b and granite-moe at
reduced size under the exact and qat plans with 1 and 2 microbatches.

Parameters are drawn by the JAX package and carried across through
``convert``; both packages run f32 ``reduced_config``s on the same
batches (``data.synthetic.lm_batch``, equal in both).  Each train step
starts from JAX's state of the step before, carried across, so a
difference of one step does not compound into the next.

Tolerances: the loss within 1e-5; a train step's loss, ``grad_norm``
(relative), parameters, ``m`` and ``v`` within 1e-5 under the exact plan
and 1e-4 under qat, as ``|a - b| <= tol * (1 + |b|)``.  AdamW divides by
``sqrt(v_hat) + 1e-8``: where ``sqrt(v_hat)`` is below
``ILL_CONDITIONED`` (on a first step, a gradient within 1e-6 of zero)
the packages' ~1e-9 gradient reordering noise decides a share of the
element's update, so a parameter element there that misses the
tolerance is held to the step's learning rate instead, and counted.  A
failing step's message reports the fake-quant codes that differ between
the packages."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import quant as jq
from repro.data import synthetic as js
from repro.models import model as JM
from repro.train import optimizer as jo
from repro.train import train_loop as jtl
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import quant as tq
from repro_torch.models import model as TM
from repro_torch.train import optimizer as to
from repro_torch.train import train_loop as ttl

ILL_CONDITIONED = 1e-6
STEP_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small CPU ops
    gain nothing from more, and the suite runs several files at once on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch,kw", [("qwen3-8b", dict(vocab=250)),
                                     ("granite-moe-1b-a400m", {})])
def test_loss_fn_matches_jax(arch, kw):
    jc, tc = jcfg.reduced_config(arch, **kw), tcfg.reduced_config(arch, **kw)
    params = JM.init(jax.random.PRNGKey(0), jc)
    batch = js.lm_batch(js.TokenStreamConfig(jc.vocab, 64, 2, 5), 0)
    want_loss, want = JM.loss_fn(params, batch, jc, loss_chunk=32)
    got_loss, got = TM.loss_fn(convert.params_from_jax(_np(params), tc),
                               {k: _t(v) for k, v in batch.items()}, tc,
                               loss_chunk=32)
    if kw:
        assert tc.padded_vocab != tc.vocab
    else:
        assert float(want["aux"]) > 0
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for key in ("ce", "aux"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5,
                                                abs=1e-7)
    assert float(got["tokens"]) == float(want["tokens"]) == 2 * 63
    with pytest.raises(ValueError, match="multiple of loss_chunk"):
        TM.loss_fn(convert.params_from_jax(_np(params), tc),
                   {k: _t(v) for k, v in batch.items()}, tc, loss_chunk=48)


def carried(jp, jstate, cfg):
    """JAX's params and optimizer state as the port's trees."""
    def conv(tree):
        return convert.params_from_jax(_np(tree), cfg)
    return conv(jp), {"master": conv(jstate["master"]),
                      "m": conv(jstate["m"]), "v": conv(jstate["v"]),
                      "step": torch.tensor(int(jstate["step"]),
                                           dtype=torch.int32)}


def _close(got, want, tol):
    """Elements of ``got`` outside ``tol * (1 + |want|)`` of ``want``."""
    return (got - want).abs() > tol * (1 + want.abs())


def compare_step(jout, tout, cfg, tcfg_, tol) -> dict:
    """One train step's outputs, the JAX package's (``jout``: params, opt
    state, metrics) against the port's: loss, relative grad_norm, ``m``
    and ``v`` within ``tol``; parameters within ``tol`` except the
    ill-conditioned elements (``sqrt(v_hat) < ILL_CONDITIONED``), which
    are held to the step's learning rate.  Returns the largest
    differences, and the count and largest difference of the
    ill-conditioned elements outside ``tol``."""
    jp, jstate, jm = jout
    tp, tstate, tm = tout
    wp, wstate = carried(jp, jstate, cfg)
    step = int(jstate["step"])
    bc2 = 1 - np.float32(tcfg_.b2) ** step
    lr = float(jm["lr"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol, \
        (float(tm["loss"]), float(jm["loss"]))
    gn = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= tol * gn
    worst = {"loss": abs(float(tm["loss"]) - float(jm["loss"])),
             "grad_norm_rel": abs(float(tm["grad_norm"]) - gn) / gn}
    for name in ("m", "v"):
        for w, g in zip(to.tree_leaves(wstate[name]),
                        to.tree_leaves(tstate[name])):
            assert not _close(g, w, tol).any(), name
        worst[name] = max(float((g - w).abs().max()) for w, g in zip(
            to.tree_leaves(wstate[name]), to.tree_leaves(tstate[name])))
    ill, worst["params"], worst["ill_conditioned_max"] = 0, 0.0, 0.0
    for w, g, v in zip(to.tree_leaves(wp), to.tree_leaves(tp),
                       to.tree_leaves(wstate["v"])):
        cond = torch.sqrt(v / bc2) >= ILL_CONDITIONED
        off = _close(g, w, tol)
        assert not (off & cond).any(), \
            f"{int((off & cond).sum())} parameter elements"
        assert float((g - w).abs().max()) <= 1.01 * lr * (1 + w.abs().max())
        ill += int((off & ~cond).sum())
        if (off & ~cond).any():
            worst["ill_conditioned_max"] = max(
                worst["ill_conditioned_max"],
                float((g - w)[off & ~cond].abs().max()))
        if cond.any():
            worst["params"] = max(worst["params"],
                                  float((g - w)[cond].abs().max()))
    worst["ill_conditioned"] = ill
    return worst


def codes_flipped(jc, tc, jp, batch, micro: int) -> str:
    """The fake-quant codes of the step's forwards (one a microbatch, on
    JAX's params) that differ between the packages: the first linear
    call where any does, and the total (a flip there moves every later
    layer's inputs, so later calls count its consequences too)."""
    codes = {"jax": [], "port": []}
    orig_j, orig_t = jq.quantize, tq.quantize

    def j_hook(x, s):
        q = orig_j(x, s)
        jax.debug.callback(lambda a: codes["jax"].append(np.asarray(a)), q,
                           ordered=True)
        return q

    def t_hook(x, s):
        q = orig_t(x, s)
        codes["port"].append(q.numpy().copy())
        return q

    jq.quantize, tq.quantize = j_hook, t_hook
    jax.clear_caches()
    try:
        for i in range(micro):
            mb = {k: v[i::micro] for k, v in batch.items()}
            jax.block_until_ready(JM.loss_fn(jp, mb, jc, mode="qat"))
            TM.loss_fn(convert.params_from_jax(_np(jp), tc),
                       {k: _t(v) for k, v in mb.items()}, tc, mode="qat")
    finally:
        jq.quantize, tq.quantize = orig_j, orig_t
        jax.clear_caches()
    diffs = [int((a != b).sum()) for a, b in zip(codes["jax"],
                                                 codes["port"])]
    first = next((i for i, d in enumerate(diffs) if d), None)
    if first is None:
        return "none"
    return (f"{diffs[first]} at quantizer call {first} of {len(diffs)}, "
            f"{sum(diffs)} in all")


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("qat", [False, True], ids=["exact", "qat"])
@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_jax(arch, qat, micro):
    jc, tc = jcfg.reduced_config(arch), tcfg.reduced_config(arch)
    if qat:
        jc = dataclasses.replace(jc, linear_mode="qat")
        tc = dataclasses.replace(tc, linear_mode="qat")
    tol = 1e-4 if qat else 1e-5
    jt = JTrainConfig(microbatches=micro, **STEP_KW)
    tt = TrainConfig(microbatches=micro, **STEP_KW)
    jp = JM.init(jax.random.PRNGKey(0), jc)
    jstate = jo.init_opt_state(jp)
    jstep = jax.jit(jtl.make_train_step(jc, jt))
    tstep = ttl.make_train_step(tc, tt)
    stream = js.TokenStreamConfig(jc.vocab, 32, 4, 0)
    report = []
    for step in range(3):
        batch = js.lm_batch(stream, step)
        tp, tstate = carried(jp, jstate, tc)
        jout = jstep(jp, jstate, batch)
        tout = tstep(tp, tstate, {k: _t(v) for k, v in batch.items()})
        try:
            worst = compare_step(jout, tout, tc, tt, tol)
        except AssertionError as e:
            flips = (codes_flipped(jc, tc, jp, batch, micro) if qat
                     else "none (exact plan)")
            raise AssertionError(f"step {step}: {e}; fake-quant codes that "
                                 f"differ from JAX's: {flips}") from e
        report.append({"step": step, **worst})
        jp, jstate = jout[0], jout[1]
    print(arch, "qat" if qat else "exact", micro, report)


