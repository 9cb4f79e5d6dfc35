"""Shared model layers: the CiM-aware linear, RMSNorm, rotary embeddings,
the gated MLP and the embedding (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the JAX package's keys,
so a converted JAX tree drops in unchanged.  Every weight-stationary
linear goes through :func:`dense`, which routes to the backend registry;
frozen (int8) params are dicts with 'w_q'.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import quant


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


def init_dense(generator, in_dim: int, out_dim: int, dtype=torch.bfloat16,
               scale: float | None = None, *, device="cpu") -> dict:
    if scale is None:
        scale = in_dim ** -0.5
    w = _normal(generator, (in_dim, out_dim), device) * scale
    return {"w": w.to(dtype)}


def dense(p: dict, x, mode: Any = "exact", relu: bool = False, dtype=None,
          *, path: str = "", out_scale=None):
    """CiM-aware linear, dispatched through the backend registry (``mode``:
    a backend name, a DeploymentPlan resolved against ``path``, or None for
    exact).  ``x`` may be a QTensor (int8 residency); dtype=None computes
    in x.dtype (f32 for a QTensor)."""
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


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """Angles [B, S, head_dim/2] for positions [B, S] (single-axis RoPE;
    M-RoPE arrives with its model family)."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * freqs


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
    if act != "silu":
        raise NotImplementedError(
            f"act={act!r}: only the gated silu MLP of the dense main path "
            "is ported")
    return {
        "gate": init_dense(generator, d_model, d_ff, dtype, device=device),
        "up": init_dense(generator, d_model, d_ff, dtype, device=device),
        "down": init_dense(generator, d_ff, d_model, dtype,
                           scale=d_ff ** -0.5, device=device),
    }


def mlp(p: dict, x: torch.Tensor, act: str = "silu", mode="exact",
        dtype=None, path: str = "mlp") -> torch.Tensor:
    if act != "silu":
        raise NotImplementedError(f"act={act!r} is not ported")
    if dtype is None:
        dtype = x.dtype
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


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def init_lm_head(generator, d_model: int, vocab: int, dtype=torch.bfloat16,
                 *, device="cpu") -> dict:
    return init_dense(generator, d_model, vocab, dtype, device=device)
