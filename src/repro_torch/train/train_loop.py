"""The train step and the training loop with auto-resume (port of
``repro/train/train_loop.py``).

``make_train_step(cfg, tcfg)`` builds ``(params, opt_state, batch) ->
(params, opt_state, metrics)``:

  * the loss is ``model.loss_fn`` (every block rematerialized, policy
    ``tcfg.remat_policy``) under the plan, or ``"qat"`` when
    ``cfg.linear_mode == "qat"``;
  * gradients come from ``torch.autograd.grad`` over the parameter
    leaves, in each parameter's dtype (JAX's ``value_and_grad``);
  * ``tcfg.microbatches`` > 1 accumulates them in f32 over interleaved
    microbatches (row ``i`` goes to microbatch ``i % m``), then divides;
  * AdamW + cosine + clipping from ``train/optimizer.py``.

``run`` drives it: it restores the latest checkpoint (params, optimizer,
step) or starts from ``model.init``, and regenerates the data stream from
that step (per-step seeding), so a stopped run resumes bit-identically.
It trains under ``torch.use_deterministic_algorithms`` (:func:`deterministic`):
the backward passes of the embedding gather and the MoE dispatch and
combine accumulate into shared rows, which the default kernels do in an
order that can change from run to run.  On the card cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before CUDA
starts (PyTorch raises, naming it, otherwise).  A step-time watchdog
flags stragglers.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.models import model as model_lib
from repro_torch.train import optimizer as opt_lib


def _micro_split(batch: dict, m: int) -> list[dict]:
    """[B, ...] -> m microbatches of B/m rows INTERLEAVED across the batch
    (microbatch i holds rows i, i + m, ...); ``positions`` [3, B, S]
    splits along axis 1."""
    def split(k, x, i):
        axis = 1 if (k == "positions" and x.ndim == 3) else 0
        if x.shape[axis] % m:
            raise ValueError(f"batch {k!r} of {x.shape[axis]} rows does not "
                             f"split into {m} microbatches")
        return x[:, i::m] if axis == 1 else x[i::m]
    return [{k: split(k, v, i) for k, v in batch.items()} for i in range(m)]


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, then
    the caller's setting again."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def make_train_step(cfg, tcfg, plan=None) -> Callable:
    # The train step takes the mode-or-plan the deployment does: a
    # DeploymentPlan (qat on the layers that deploy int8, exact on the
    # rest) or the config's linear_mode string.
    mode = plan if plan is not None else (
        "qat" if cfg.linear_mode == "qat" else None)

    def value_and_grad(params, batch):
        leaves = opt_lib.tree_leaves(params)
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in leaves]
            loss, mets = model_lib.loss_fn(
                opt_lib.tree_unflatten_like(params, xs), batch, cfg,
                remat_policy=getattr(tcfg, "remat_policy", "nothing"),
                mode=mode)
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, \
            grads

    def train_step(params, opt_state, batch):
        m = tcfg.microbatches
        if m > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
                   for p in opt_lib.tree_leaves(params)]
            loss = ce = 0.0
            for mb in _micro_split(batch, m):
                l_mb, mets, grads = value_and_grad(params, mb)
                acc = [a + g for a, g in zip(acc, grads)]
                loss = loss + l_mb
                ce = ce + mets["ce"]
            grads = [a / m for a in acc]
            loss, ce = loss / m, ce / m
        else:
            loss, mets, grads = value_and_grad(params, batch)
            ce = mets["ce"]
        new_params, new_opt, opt_metrics = opt_lib.adamw_update(
            opt_lib.tree_unflatten_like(params, grads), opt_state, params,
            tcfg)
        return new_params, new_opt, {"loss": loss, "ce": ce, **opt_metrics}

    return train_step


def run(cfg, tcfg, *, ckpt_dir: str, steps: int | None = None,
        log_every: int = 10, straggler_factor: float = 3.0,
        callback=None, device="cuda") -> dict:
    """Single-device training with auto-resume: batches of 8 sequences
    (256 tokens when the vocab passes 1000, else 128) from
    ``data.synthetic.lm_batch``; a checkpoint every
    ``tcfg.checkpoint_every`` steps and at the last, written in the
    background.  Returns ``{"params", "opt_state", "history"}``."""
    dev = device_lib.resolve(device)
    steps = steps or tcfg.total_steps
    stream = synthetic.TokenStreamConfig(
        vocab=cfg.vocab, seq_len=256 if cfg.vocab > 1000 else 128,
        global_batch=8, seed=tcfg.seed)

    mgr = CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints)
    params = model_lib.init(
        cfg, torch.Generator(device=dev).manual_seed(tcfg.seed), device=dev)
    opt_state = opt_lib.init_opt_state(params)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        restored = mgr.restore(latest, {"params": params, "opt": opt_state},
                               device=dev)
        params, opt_state = restored["params"], restored["opt"]
        start = latest
    train_step = make_train_step(cfg, tcfg)

    times, history = [], []
    with deterministic():
        for step in range(start, steps):
            batch = synthetic.lm_batch(stream, step, device=dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch)
            # Reading the metrics to the host waits for the step.
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            times.append(dt)
            recent = sorted(times[-50:])
            med = recent[len(recent) // 2]
            metrics["step_time_s"] = dt
            metrics["straggler"] = bool(len(times) > 5
                                        and dt > straggler_factor * med)
            history.append({"step": step, **metrics})
            if callback:
                callback(step, params, metrics)
            if (step + 1) % tcfg.checkpoint_every == 0 or step + 1 == steps:
                mgr.save_async(step + 1, {"params": params,
                                          "opt": opt_state})
            if step % log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"ce {metrics['ce']:.4f} lr {metrics['lr']:.2e} "
                      f"gnorm {metrics['grad_norm']:.2f} {dt*1e3:.0f}ms"
                      + (" STRAGGLER" if metrics["straggler"] else ""))
    mgr.wait()
    return {"params": params, "opt_state": opt_state, "history": history}
