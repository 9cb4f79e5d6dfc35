"""Shared model layers: the CiM-aware linear, RMSNorm and LayerNorm,
rotary embeddings (with M-RoPE), the gated and gelu MLPs and the
embedding (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the JAX package's keys,
so a converted JAX tree drops in unchanged.  Every ``init_*`` has a twin
``*_pspec`` returning the same tree with *logical axis name tuples* as
leaves (resolved to mesh placements by ``distributed/sharding.py``):
'vocab', 'embed', 'embed_sharded', 'mlp', 'q_heads', 'kv_heads',
'experts', 'ssm_inner', None (replicated).  Every weight-stationary
linear goes through :func:`dense`, which routes to the backend registry;
frozen (int8) params are dicts with 'w_q'.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import backend as backend_lib
from repro_torch.core import quant
from repro_torch.distributed import spmd


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


def init_dense(generator, in_dim: int, out_dim: int, dtype=torch.bfloat16,
               scale: float | None = None, *, device="cpu") -> dict:
    if scale is None:
        scale = in_dim ** -0.5
    w = _normal(generator, (in_dim, out_dim), device) * scale
    return {"w": w.to(dtype)}


def dense_pspec(in_axis: str | None, out_axis: str | None,
                frozen: bool = False) -> dict:
    if frozen:
        return {"w_q": (in_axis, out_axis), "w_scale": (out_axis,),
                "a_scale": ()}
    return {"w": (in_axis, out_axis)}


def dense(p: dict, x, mode: Any = "exact", relu: bool = False, dtype=None,
          *, path: str = "", out_scale=None):
    """CiM-aware linear, dispatched through the backend registry (``mode``:
    a backend name, a DeploymentPlan resolved against ``path``, or None for
    exact).  ``x`` may be a QTensor (int8 residency); dtype=None computes
    in x.dtype (f32 for a QTensor).  On a mesh, a column-parallel ``p``
    (``spmd.ColumnShard``) computes this rank's output columns and
    all-gathers them over 'model'."""
    q_in = isinstance(x, quant.QTensor)
    if dtype is None:
        dtype = torch.float32 if q_in else x.dtype
    name = backend_lib.resolve_backend(mode, path, params=p)
    backend = backend_lib.get_backend(name)
    if q_in and not backend.frozen:
        x = x.dequant().to(dtype)
    w = p["w_q"] if "w_q" in p else p["w"]
    spec = backend_lib.LinearSpec(
        in_dim=w.shape[-2], out_dim=w.shape[-1], use_bias="b" in p,
        relu=relu, mode=name, dtype=dtype)
    if out_scale is not None and not backend.supports_out_requant:
        out_scale = None
    y = backend.apply(p, x, spec, out_scale=out_scale)
    if isinstance(p, spmd.ColumnShard):
        y = spmd.gather_columns(y, p)
    if isinstance(y, quant.QTensor):
        return y
    return y.to(dtype)


def init_rmsnorm(dim: int, *, device="cpu") -> dict:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p["scale"]).to(dt)


def init_layernorm(dim: int, *, device="cpu") -> dict:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(dt)


@functools.cache
def _rope_host(head_dim: int, theta: float) -> np.ndarray:
    """``1 / theta ** (arange(0, head_dim, 2) / head_dim)`` on the host,
    bit for bit as the JAX package computes it: the exponents in f32, the
    power taken in float64 and rounded once to f32 (XLA's f32 power is
    correctly rounded there; torch's f32 ``pow`` is one ulp off on some
    inputs), then the f32 reciprocal."""
    exps = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    power = (np.float64(np.float32(theta)) ** exps.astype(np.float64)
             ).astype(np.float32)
    return np.float32(1.0) / power


@functools.cache
def _rope_on(head_dim: int, theta: float, device) -> torch.Tensor:
    return torch.from_numpy(_rope_host(head_dim, theta)).to(device)


def _rope_freqs(head_dim: int, theta: float, device,
                fake: bool = False) -> torch.Tensor:
    """The frequencies on ``device``, made once per (head_dim, theta,
    device); a fake trace (``FakeTensorMode``) gets a tensor of its own,
    never cached, so no fake tensor reaches a later real step."""
    if fake:
        return torch.from_numpy(_rope_host(head_dim, theta)).to(device)
    return _rope_on(head_dim, theta, device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections=None) -> torch.Tensor:
    """Angles [.., S, head_dim/2].  ``positions`` is [B, S] (single-axis
    RoPE) or, with ``sections`` (M-RoPE), [3, B, S] t/h/w position ids:
    section *i* takes the next ``sections[i]`` frequency bands from
    position axis *i* (the sections sum to head_dim/2)."""
    freqs = _rope_freqs(head_dim, theta, positions.device,
                        isinstance(positions, FakeTensor))
    if sections is None:
        return positions[..., None].to(torch.float32) * freqs
    if positions.ndim != 3 or positions.shape[0] != len(sections):
        raise ValueError(f"M-RoPE needs positions [{len(sections)}, B, S], "
                         f"got {tuple(positions.shape)}")
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(positions[i][..., None].to(torch.float32)
                     * freqs[start:start + sec])
        start += sec
    if start != freqs.shape[0]:
        raise ValueError("M-RoPE sections must sum to head_dim/2")
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; angles [B, S, D/2] -> rotated x (pairwise halves)."""
    dt = x.dtype
    x = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def init_mlp(generator, d_model: int, d_ff: int, act: str = "silu",
             dtype=torch.bfloat16, *, device="cpu") -> dict:
    """The gated (SwiGLU) MLP ``{gate, up, down}`` for ``act="silu"``,
    else the plain two-layer MLP ``{in, out}``."""
    if act != "silu":
        return {
            "in": init_dense(generator, d_model, d_ff, dtype, device=device),
            "out": init_dense(generator, d_ff, d_model, dtype,
                              scale=d_ff ** -0.5, device=device),
        }
    return {
        "gate": init_dense(generator, d_model, d_ff, dtype, device=device),
        "up": init_dense(generator, d_model, d_ff, dtype, device=device),
        "down": init_dense(generator, d_ff, d_model, dtype,
                           scale=d_ff ** -0.5, device=device),
    }


def mlp_pspec(act: str = "silu", frozen: bool = False) -> dict:
    if act == "silu":
        return {"gate": dense_pspec("embed", "mlp", frozen),
                "up": dense_pspec("embed", "mlp", frozen),
                "down": dense_pspec("mlp", "embed", frozen)}
    return {"in": dense_pspec("embed", "mlp", frozen),
            "out": dense_pspec("mlp", "embed", frozen)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu", mode="exact",
        dtype=None, path: str = "mlp") -> torch.Tensor:
    """SwiGLU for ``act="silu"``; otherwise ``out(gelu(in(x)))`` with the
    tanh form of gelu (``jax.nn.gelu``'s default), computed in f32."""
    if dtype is None:
        dtype = x.dtype
    if act != "silu":
        h = dense(p["in"], x, mode, dtype=dtype, path=f"{path}/in")
        h = torch.nn.functional.gelu(h.to(torch.float32),
                                     approximate="tanh").to(dtype)
        return dense(p["out"], h, mode, dtype=dtype, path=f"{path}/out")
    x_in = x
    if backend_lib.residency_enabled(mode):
        x_in = backend_lib.shared_quant((p["gate"], p["up"]), x)
    g = dense(p["gate"], x_in, mode, dtype=dtype, path=f"{path}/gate")
    u = dense(p["up"], x_in, mode, dtype=dtype, path=f"{path}/up")
    h = torch.nn.functional.silu(g.to(torch.float32)).to(dtype) * u
    return dense(p["down"], h, mode, dtype=dtype, path=f"{path}/down")


def init_embedding(generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16, *, device="cpu") -> dict:
    e = _normal(generator, (vocab, d_model), device) * (d_model ** -0.5)
    return {"table": e.to(dtype)}


def embedding_pspec() -> dict:
    # The embed dim over 'model': the token gather is shard-local.
    return {"table": (None, "embed_sharded")}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def init_lm_head(generator, d_model: int, vocab: int, dtype=torch.bfloat16,
                 *, device="cpu") -> dict:
    return init_dense(generator, d_model, vocab, dtype, device=device)


def lm_head_pspec(frozen: bool = False) -> dict:
    return dense_pspec("embed", "vocab", frozen)
