"""AdamW with f32 master weights, a cosine schedule and global-norm
clipping (port of ``repro/train/optimizer.py``).

The state mirrors the parameter tree: f32 ``master``, ``m`` and ``v``
leaves and an int32 ``step``.  Every update is taken in the JAX
package's f32 order; ``b ** step`` is taken in float64 and rounded once
to f32, the correctly rounded value XLA's f32 power gives.  ``torch.optim``
is not used: its update order differs.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree, depth first in the
    tree's own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves) -> object:
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _f32(x: float) -> float:
    return float(np.float32(x))


def cosine_schedule(step, lr: float, warmup: int, total: int
                    ) -> torch.Tensor:
    """The learning rate at ``step`` (f32): linear warmup, then a cosine
    to 0 at ``total``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr * step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = 0.5 * lr * (1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup, warm, cos)


def init_opt_state(params) -> dict:
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32).clone(),
                           params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _pow_f32(base: float, step: torch.Tensor) -> torch.Tensor:
    """``f32(base) ** f32(step)``, correctly rounded to f32."""
    b = torch.tensor(_f32(base), dtype=torch.float64, device=step.device)
    return torch.pow(b, step.to(torch.float64)).to(torch.float32)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg) -> tuple:
    """Returns (new params in each param's dtype, new opt state, metrics
    ``{"lr", "grad_norm"}``)."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                           1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1 - _pow_f32(b1, step_f)
    bc2 = 1 - _pow_f32(b2, step_f)

    def upd(g, m, v, master):
        g = g.to(torch.float32) * clip
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay * master
        return m_new, v_new, master - lr * delta

    new = [upd(g, m, v, ma) for g, m, v, ma in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(opt_state["master"]))]
    new_opt = {
        "master": tree_unflatten_like(params, [n[2] for n in new]),
        "m": tree_unflatten_like(params, [n[0] for n in new]),
        "v": tree_unflatten_like(params, [n[1] for n in new]),
        "step": step,
    }
    new_params = tree_map(lambda ma, p: ma.to(p.dtype), new_opt["master"],
                          params)
    return new_params, new_opt, {"lr": lr, "grad_norm": gnorm}
