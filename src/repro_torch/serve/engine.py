"""Decode step and sampler shared by the continuous-batching driver (port of
``Engine.make_sample`` / ``Engine.make_step`` of ``repro/serve/engine.py``).

The blocking-prefill ``Engine.generate`` over a dense cache and seeded
sampling (the JAX package folds the request id and step into a threefry
key) are not ported yet (ROADMAP queue 1); greedy decoding is.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.models import model as model_lib

SEEDED_SAMPLING_TODO = (
    "seeded sampling (threefry fold_in + categorical, one key per request "
    "id and step) is not ported yet: ROADMAP queue 1, 'seeded sampling'")


class Engine:
    def __init__(self, params, cfg, *, plan=None, mode=None):
        if plan is None and mode is not None:
            plan = backend_lib.as_plan(mode)
        self.params = params
        self.cfg = cfg
        self.plan = plan

    def make_sample(self, plan, greedy: bool):
        """sample(logits [B,V], rng, rids [B], t, temperature) -> [B] int32
        (greedy: argmax, first maximum on ties like ``jnp.argmax``)."""
        del plan
        if not greedy:
            raise NotImplementedError(SEEDED_SAMPLING_TODO)

        def sample(logits, rng, rids, t, temperature):
            return torch.argmax(logits, dim=-1).to(torch.int32)

        return sample

    def make_step(self, plan, greedy: bool):
        """One fused decode+sample step over a paged-pool cache view.

        Returns ``(nxt, lp_tok, ok, caches)``: ``ok`` is False for a row
        whose logits came back non-finite (the engine quarantines it as
        FAILED); ``poison`` ([B] bool) overwrites a row's logits with NaN
        before that check."""
        cfg = self.cfg
        sample = self.make_sample(plan, greedy)

        def step(params, tok, caches, rng, rids, t, temperature,
                 poison=None):
            logits, caches = model_lib.decode_step(
                params, {"tokens": tok[:, None]}, caches, cfg, mode=plan)
            last = logits[:, -1]
            if poison is not None:
                last = torch.where(poison[:, None], torch.nan, last)
            ok = torch.isfinite(last.to(torch.float32)).all(dim=-1)
            lp = torch.log_softmax(last.to(torch.float32), dim=-1)
            lp_tok = torch.gather(lp, 1, tok[:, None].long())[:, 0]
            nxt = sample(last, rng, rids, t, temperature)
            nxt = torch.where(ok, nxt, 0)
            lp_tok = torch.where(ok, lp_tok, 0.0)
            return nxt, lp_tok, ok, caches

        return step
