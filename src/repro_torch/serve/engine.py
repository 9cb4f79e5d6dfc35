"""Serving engine: bucketed prefill into dense KV caches, then decode with
greedy or seeded sampling (port of ``repro/serve/engine.py``).

* **Bucketed prefill** -- prompt lengths are right-padded to
  ``seq_bucket`` multiples with the true length threaded to
  ``model.prefill`` (dense attention only), as in the JAX package, whose
  jit cache holds one prefill per bucket.  Pads are causally invisible and
  the cache's write cursor is rewound past them.
* **Decode loops** -- ``generate(decode_loop="scan")`` is the counterpart
  of the JAX package's single jitted ``lax.while_loop``: one function runs
  prefill and every decode step into preallocated device buffers and
  reads nothing from the device inside the loop unless ``stop_tokens``
  asks for the early exit (one read of the done mask per step, as the
  JAX loop's predicate).  ``"eager"`` is the per-token reference loop,
  one call of the decode step per token.
* **Stop tokens** -- a row is done once it emits any of ``stop_tokens``;
  finished rows emit ``pad_token`` with logprob 0, and the loop stops when
  every row is done.
* **Batch-composition-independent sampling** -- each row's key is
  ``fold_in(fold_in(key, request_id), step)`` (``serve/prng.py``, bit for
  bit ``jax.random``'s), never a positional split of a batch key, so a
  request draws the same tokens whatever batch it shares, and the same
  tokens as the JAX engine at the same key.

``dispatch_count`` / ``last_dispatch_count`` count the host's calls of
the engine's functions: one per ``generate`` in ``"scan"`` mode (the
whole loop), and one prefill + one first sample + one per decode step in
``"eager"`` mode.  They count what the JAX package counts as jitted
executions; here every call still launches its device kernels one by
one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.core import backend as backend_lib
from repro_torch.models import model as model_lib
from repro_torch.serve import prng


@dataclasses.dataclass
class GenerationResult:
    tokens: Any           # [B, T_new] int32
    logprobs: Any         # [B, T_new] float32
    steps: int            # decode steps actually executed (<= T_new)
    done: Any = None      # [B] bool: emitted a stop token (None: no stops)


class Engine:
    def __init__(self, params, cfg, *, max_len: int = 512, plan=None,
                 mode=None, seq_bucket: int = 32, device="cuda"):
        if plan is None and mode is not None:
            plan = backend_lib.as_plan(mode)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.plan = plan                  # DeploymentPlan | None (exact)
        self.seq_bucket = seq_bucket
        self.device = device_lib.resolve(device)
        self.dispatch_count = 0           # lifetime
        self.last_dispatch_count = 0      # most recent generate() call

    def _dispatch(self, fn, *args):
        self.dispatch_count += 1
        self.last_dispatch_count += 1
        return fn(*args)

    # --------------------------------------------------------- functions

    def prefill_fn(self, plan):
        """``model.prefill`` bound to this engine's config, ``max_len`` and
        ``plan``: ``f(params, batch) -> (logits [B, 1, V], caches)``."""
        return functools.partial(model_lib.prefill, cfg=self.cfg,
                                 max_len=self.max_len, mode=plan)

    def make_sample(self, plan, greedy: bool):
        """sample(logits [B,V], rng, rids [B], t, temperature) -> [B] int32.

        Greedy: ``argmax``, the first maximum on ties like ``jnp.argmax``.
        Otherwise each row's key is ``fold_in(fold_in(rng, rid), t)`` and
        its draw ``categorical(key, logits / temperature)``: it depends
        only on (run key, request id, step), never on the row's position
        or its batch neighbours.  ``rng`` is a key (``prng``), ``t`` an int
        or a [B] per-row step tensor, ``temperature`` a float32 tensor
        (the logits are divided by it, as in the JAX package)."""
        del plan

        def sample(logits, rng, rids, t, temperature):
            if greedy:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            keys = prng.fold_in(
                prng.fold_in(rng.expand(*rids.shape, 2), rids), t)
            return prng.categorical(
                keys, logits.to(torch.float32) / temperature).to(
                    torch.int32)

        return sample

    def make_step(self, plan, greedy: bool):
        """One fused decode+sample step; ``caches`` may be the dense
        per-call cache or a paged-pool view, ``t`` an int or per-row.

        Returns ``(nxt, lp_tok, ok, caches)``: ``ok`` is False for a row
        whose logits came back non-finite (the continuous engine
        quarantines it as FAILED); ``poison`` ([B] bool) overwrites a row's
        logits with NaN before that check."""
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

    def _gen_fn(self, plan, greedy: bool, max_new: int,
                stop_tokens: tuple[int, ...] | None):
        """Prefill + the whole decode loop as one function (the JAX
        package's single jitted call).  Without stop tokens it runs
        ``max_new`` steps and reads nothing from the device; with them it
        reads the done mask once per step to exit early."""
        prefill = self.prefill_fn(plan)
        sample = self.make_sample(plan, greedy)
        step = self.make_step(plan, greedy)

        def gen(params, batch, rng, rids, temperature, pad_token):
            logits, caches = prefill(params, batch)
            tok = sample(logits[:, -1], rng, rids, 0, temperature)
            b = tok.shape[0]
            dev = tok.device
            toks = torch.full((b, max_new), pad_token, dtype=torch.int32,
                              device=dev)
            lps = torch.zeros((b, max_new), dtype=torch.float32, device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            stop = (None if stop_tokens is None else torch.tensor(
                stop_tokens, dtype=torch.int32, device=dev))
            t = 0
            while t < max_new:
                if stop is not None and t > 0 and bool(done.all()):
                    break
                toks[:, t] = torch.where(done, pad_token, tok)
                nxt, lp, _, caches = step(params, tok, caches, rng, rids,
                                          t + 1, temperature)
                lps[:, t] = torch.where(done, 0.0, lp)
                if stop is not None:
                    done = done | (tok[:, None] == stop[None, :]).any(-1)
                tok = nxt
                t += 1
            return toks, lps, done, t

        return gen

    # ----------------------------------------------------------- prefill

    def bucket(self, batch: dict) -> dict:
        """Right-pad the prompt to a ``seq_bucket`` multiple (capped at
        ``max_len``) with its true ``length``, for dense attention without
        a sliding window; otherwise return ``batch`` unchanged."""
        if (self.seq_bucket <= 1
                or set(batch) != {"tokens"}
                or self.cfg.arch_type != "dense"
                or self.cfg.sliding_window is not None):
            return batch
        tokens = batch["tokens"]
        s = tokens.shape[1]
        s_pad = min(-(-s // self.seq_bucket) * self.seq_bucket,
                    self.max_len)
        if s_pad <= s:
            return batch
        return {"tokens": torch.nn.functional.pad(tokens, (0, s_pad - s)),
                "length": s}

    # ---------------------------------------------------------- generate

    def generate(self, batch: dict, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, key=None, plan=None,
                 stop_tokens: Sequence[int] | None = None,
                 pad_token: int = 0, request_ids=None,
                 decode_loop: str = "scan") -> GenerationResult:
        """Generate up to ``max_new_tokens`` per sequence of
        ``batch["tokens"]`` ``[B, S]`` (optionally pre-bucketed with its
        ``length``).

        ``temperature > 0`` with a ``key`` (a ``prng`` key, or a JAX key's
        ``uint32[2]`` data) samples; otherwise decoding is greedy.
        ``request_ids`` ([B] ints, default ``arange(B)``) seed each row's
        sampler.  ``stop_tokens`` marks a row done once it emits any of the
        ids; finished rows emit ``pad_token`` with logprob 0.  The prompt
        plus ``max_new_tokens`` must fit in ``max_len``."""
        if decode_loop not in ("scan", "eager"):
            raise ValueError(f"decode_loop must be 'scan' or 'eager', "
                             f"got {decode_loop!r}")
        if "tokens" not in batch:
            raise ValueError(f"batch has no token input: {set(batch)}")
        plan = self.plan if plan is None else backend_lib.as_plan(plan)
        dev = self.device
        batch = dict(batch, tokens=torch.as_tensor(
            batch["tokens"], device=dev).long())
        b, s = batch["tokens"].shape
        length = int(batch.get("length", s))
        if length + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {length} + max_new_tokens {max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        greedy = temperature <= 0 or key is None
        rng = (prng.PRNGKey(0, device=dev) if key is None
               else prng.as_key(key, dev))
        temp = torch.tensor(max(temperature, 1e-6), dtype=torch.float32,
                            device=dev)
        rids = (torch.arange(b, dtype=torch.int32, device=dev)
                if request_ids is None else torch.as_tensor(
                    request_ids, device=dev).to(torch.int32))
        stops = None if stop_tokens is None else \
            tuple(int(t) for t in stop_tokens)
        self.last_dispatch_count = 0

        if decode_loop == "scan":
            fn = self._gen_fn(plan, greedy, max_new_tokens, stops)
            toks, lps, done, t = self._dispatch(
                fn, self.params, self.bucket(batch), rng, rids, temp,
                pad_token)
            return GenerationResult(
                tokens=toks, logprobs=lps, steps=t,
                done=None if stops is None else done)

        # ---- eager reference loop (one call of the step per token) -----
        prefill = self.prefill_fn(plan)
        sample = self.make_sample(plan, greedy)
        step = self.make_step(plan, greedy)
        logits, caches = self._dispatch(prefill, self.params,
                                        self.bucket(batch))
        tok = self._dispatch(sample, logits[:, -1], rng, rids, 0, temp)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        stop = (None if stops is None
                else torch.tensor(stops, dtype=torch.int32, device=dev))
        toks, lps = [], []
        steps = 0
        for t in range(max_new_tokens):
            toks.append(tok if stop is None
                        else torch.where(done, pad_token, tok))
            nxt, lp, _, caches = self._dispatch(
                step, self.params, tok, caches, rng, rids, t + 1, temp)
            lps.append(lp if stop is None else torch.where(done, 0.0, lp))
            if stop is not None:
                done = done | (tok[:, None] == stop[None, :]).any(-1)
            tok = nxt
            steps = t + 1
            if stop is not None and bool(done.all()):
                break
        pad_col = torch.full((b,), pad_token, dtype=torch.int32, device=dev)
        zero_col = torch.zeros(b, dtype=torch.float32, device=dev)
        toks += [pad_col] * (max_new_tokens - len(toks))
        lps += [zero_col] * (max_new_tokens - len(lps))
        return GenerationResult(
            tokens=torch.stack(toks, dim=1), logprobs=torch.stack(lps, dim=1),
            steps=steps, done=None if stops is None else done)
