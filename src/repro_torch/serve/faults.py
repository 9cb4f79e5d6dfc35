"""Seeded fault injection for the continuous serve engine (a copy of
``repro/serve/faults.py``; numpy only).

The chaos layer is deliberately thin: :class:`FaultInjector` only *decides*
what goes wrong each scheduler round; every fault is then applied through
the engine's real code paths, never a mock —

* ``hide`` / ``unhide`` — :meth:`BlockAllocator.hide_blocks` withdraws
  free blocks from circulation (a co-tenant, a leak under test), creating
  genuine allocator exhaustion: admission backpressure and growth-failure
  preemption storms fall out of the normal scheduler logic.
* ``preempt`` — forced evictions via the same newest-admitted-first
  victim selection and recompute re-admission a real pool squeeze uses.
* ``poison`` — NaN logits for a request's row, injected inside the fused
  decode step (``make_step(poison=...)``) so the non-finite guard is
  exercised where an overflowed activation would actually surface.
* ``cancel`` — surprise :meth:`ContinuousEngine.cancel` calls.

Determinism: the schedule is a pure function of (seed, config, round
index) — same seed, same engine inputs => same faults, same results —
which is what lets chaos tests assert *bit-identity* of surviving
requests against a fault-free run.  ``stop_round`` ends the chaos window
(and releases hidden blocks) so every run drains to a clean allocator.

Usage::

    fi = FaultInjector(seed=7, hide_prob=0.3, preempt_prob=0.2,
                       stop_round=40)
    results = engine.run(reqs, faults=fi)

or fully scripted, one action dict per round::

    fi = FaultInjector.scripted({3: {"poison": [2]}, 5: {"cancel": [4]}})
"""
from __future__ import annotations

import dataclasses

import numpy as np


class CrashPoint(RuntimeError):
    """Raised out of the serve loop by a ``{"crash": True}`` fault action:
    the simulated hard process death for crash-recovery chaos.  In-flight
    requests are NOT retired (no finish events, no partial results) —
    exactly like a kill -9 — so the recovery path must rebuild everything
    from the last snapshot file (``ContinuousEngine.restore`` +
    ``resume``); only process-hygiene cleanup (in-memory block frees)
    runs via the generator's normal teardown."""

    def __init__(self, round_idx: int, now: int):
        super().__init__(
            f"injected crash at scheduler round {round_idx} (sim step {now})")
        self.round_idx = round_idx
        self.now = now


def describe(acts: dict) -> list[tuple[str, dict]]:
    """Flatten one round's action dict into ``(event_name, args)`` pairs
    for the trace timeline: ``{"hide": 2, "poison": [3]}`` becomes
    ``[("fault:hide", {"n": 2}), ("fault:poison", {"rids": [3]})]``.  The
    engine records each pair as a named instant, so a chaos run's injected
    schedule is visually replayable next to its fallout (preemption
    storms, FAILED quarantines) in perfetto."""
    out = []
    for kind, val in acts.items():
        if isinstance(val, bool):
            args: dict = {}
        elif isinstance(val, (list, tuple)):
            args = {"rids": [int(v) for v in val]}
        else:
            args = {"n": int(val)}
        out.append((f"fault:{kind}", args))
    return out


@dataclasses.dataclass
class FaultInjector:
    """Per-round chaos schedule for ``ContinuousEngine.run_stream``.

    Each scheduler round the engine calls :meth:`on_round` and applies the
    returned action dict (any subset of):

    ``{"hide": k}``        withdraw k free pool blocks,
    ``{"unhide": True}``   release all hidden blocks,
    ``{"preempt": k}``     force-preempt k newest-admitted requests,
    ``{"poison": [rids]}`` NaN the logits of these requests' rows,
    ``{"cancel": [rids]}`` cancel these requests,
    ``{"flush": True}``    drop every cached-free prefix-cache entry
    (``BlockAllocator.drop_cached``) — cache loss must only cost misses,
    ``{"crash": True}``    raise :class:`CrashPoint` — kill the run loop
    mid-flight with no cleanup (recoverable only via snapshot/restore).

    Probabilistic mode draws each action independently per round inside
    the ``[start_round, stop_round)`` window; after ``stop_round`` it only
    emits ``unhide`` so the run can drain.  ``log`` records every injected
    action ``(round, sim_now, actions)`` for test forensics."""

    seed: int = 0
    hide_prob: float = 0.0        # P(hide a few free blocks) per round
    hide_max: int = 4             # 1..hide_max blocks per hide event
    unhide_prob: float = 0.25     # P(release hidden blocks) per round
    preempt_prob: float = 0.0     # P(forced preemption burst) per round
    preempt_max: int = 2          # 1..preempt_max victims per burst
    poison_prob: float = 0.0      # P(NaN one running request's logits)
    cancel_prob: float = 0.0      # P(cancel one live/queued request)
    flush_prob: float = 0.0       # P(drop all cached prefix blocks)
    start_round: int = 0          # first chaotic round
    stop_round: int | None = None   # chaos ends here (hidden blocks freed)

    def __post_init__(self):
        self._script: dict[int, dict] | None = None
        self.reset()

    @classmethod
    def scripted(cls, events: dict[int, dict]) -> "FaultInjector":
        """Exact per-round schedule: {round_index: action_dict}.  Rounds
        not listed inject nothing."""
        fi = cls()
        fi._script = {int(k): dict(v) for k, v in events.items()}
        return fi

    @classmethod
    def crash_at(cls, round_idx: int, **extra: dict) -> "FaultInjector":
        """Scripted injector that kills the run loop at ``round_idx``
        (plus any extra per-round actions, e.g. pre-crash preemptions):
        ``FaultInjector.crash_at(10, **{"6": {"preempt": 2}})``."""
        events: dict[int, dict] = {int(k): dict(v)
                                   for k, v in extra.items()}
        events.setdefault(round_idx, {})["crash"] = True
        return cls.scripted(events)

    def reset(self) -> None:
        """Rewind to the start of the schedule (call between runs when
        reusing one injector; a fresh instance needs nothing)."""
        self._rng = np.random.default_rng(self.seed)
        self.log: list[tuple[int, int, dict]] = []

    def on_round(self, round_idx: int, now: int, running_rids,
                 queued_rids) -> dict:
        """The engine's per-round hook; returns this round's action dict
        (empty: no faults)."""
        if self._script is not None:
            acts = dict(self._script.get(round_idx, {}))
            if acts:
                self.log.append((round_idx, now, acts))
            return acts
        if round_idx < self.start_round:
            return {}
        if self.stop_round is not None and round_idx >= self.stop_round:
            # Chaos window over: release pool pressure so the run drains
            # (idempotent once everything is unhidden).
            return {"unhide": True}
        rng = self._rng
        acts: dict = {}
        if rng.random() < self.unhide_prob:
            acts["unhide"] = True
        if rng.random() < self.hide_prob:
            acts["hide"] = int(rng.integers(1, self.hide_max + 1))
        if running_rids and rng.random() < self.preempt_prob:
            acts["preempt"] = int(rng.integers(1, self.preempt_max + 1))
        if running_rids and rng.random() < self.poison_prob:
            acts["poison"] = [int(rng.choice(list(running_rids)))]
        if self.flush_prob > 0 and rng.random() < self.flush_prob:
            # Gated on the prob so a disabled flush consumes no draw —
            # legacy seeds keep their exact schedules.
            acts["flush"] = True
        if self.cancel_prob > 0:
            cands = list(running_rids) + list(queued_rids)
            if cands and rng.random() < self.cancel_prob:
                acts["cancel"] = [int(rng.choice(cands))]
        if acts:
            self.log.append((round_idx, now, acts))
        return acts
