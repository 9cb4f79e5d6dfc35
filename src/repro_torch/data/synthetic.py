"""Deterministic synthetic data (port of ``repro/data/synthetic.py``).

* Token streams for LM training, seeded per step: resuming from step N
  regenerates exactly the batches N, N+1, ... that a run never stopped
  would have seen (the data half of resume).  A Markov-ish stream of
  state-conditioned token ranges plus geometric noise, drawn through
  ``prng.py``, so a batch equals the JAX package's at the same seed
  and step (up to ``prng.geometric``'s ``log`` rounding).
* Synthetic CIFAR-like images for the VGG-8 experiments: per-class
  frequency/orientation patterns plus noise; CIFAR itself is not
  available offline, so Fig. 10 is reproduced mechanistically on this
  set.  They are drawn at a ``prng`` key, as the JAX package draws them
  at that key: the labels exactly, the images within 2 f32 ulp of 1.0
  (their patterns go through ``sin``/``cos``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_states: int = 64


def lm_batch(cfg: TokenStreamConfig, step: int, *, device="cpu") -> dict:
    """The batch of ``step``, deterministic in (seed, step): int32
    ``tokens`` and ``labels`` [global_batch, seq_len] (labels are the
    next token, -1 at the last position), drawn on the host and placed
    on ``device``."""
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    k1, k2 = prng.split(key)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    states = prng.randint(k1, (b, s), 0, cfg.markov_states)
    span = max(v // cfg.markov_states, 1)
    offs = prng.geometric(k2, 0.2, (b, s)).clamp(1, span) - 1
    tokens = (states * span + offs).clamp(0, v - 1).to(torch.int32)
    labels = torch.cat([tokens[:, 1:],
                        torch.full((b, 1), -1, dtype=torch.int32)], dim=1)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}


def host_shard(batch: dict, n_shards: int, shard_idx: int) -> dict:
    """This host's slice of the global batch (rows ``shard_idx * per`` to
    ``(shard_idx + 1) * per``)."""
    def slc(x):
        per = x.shape[0] // n_shards
        return x[shard_idx * per:(shard_idx + 1) * per]
    return {k: slc(v) for k, v in batch.items()}


def _f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of an f32 tensor rounded once from float64: torch's f32
    ``sin``/``cos`` round further from XLA's than this does."""
    return fn(x.to(torch.float64)).to(torch.float32)


def synthetic_cifar(key, n: int, n_classes: int = 10,
                    size: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Images [n, size, size, 3] in [0, 1] (NHWC) and int64 labels [n]:
    at a ``prng`` key (split in three: labels, noise, jitter) on the
    key's device."""
    k1, k2, k3 = prng.split(prng.as_key(key), 3).unbind(-2)
    dev = k1.device
    labels = prng.randint(k1, (n,), 0, n_classes).to(torch.int64)
    ar = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    cls = torch.arange(n_classes, device=dev)
    thetas = math.pi * cls.to(torch.float32) / n_classes
    freqs = 2 * math.pi * (2 + cls % 5).to(torch.float32) / size
    f = freqs[labels][:, None, None]
    proj = (xx[None] * _f32(torch.cos, thetas[labels])[:, None, None]
            + yy[None] * _f32(torch.sin, thetas[labels])[:, None, None])
    img = torch.stack([_f32(torch.sin, f * proj + c * 0.7)
                       for c in range(3)], dim=-1) * 0.35 + 0.5
    noise = prng.normal(k2, img.shape)
    jitter = prng.normal(k3, (n, 1, 1, 3))
    return torch.clamp(img + 0.15 * noise + 0.1 * jitter, 0, 1), labels
