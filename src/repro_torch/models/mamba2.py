"""Mamba-2 block (state-space duality / SSD, arXiv:2405.21060): port of
``repro/models/mamba2.py``, function for function.

  y = SSD(x, dt, A, B, C):  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;
                            y_t = C_t^T h_t + D x_t

* Prefill takes the chunked dual form: the intra-chunk "attention-like"
  term (C B^T masked by the decay kernel L) plus the inter-chunk state
  recurrence, a loop over chunk states (the JAX package's ``lax.scan``).
* Decode keeps the constant-size recurrent state ``[B, H, P, N]`` (f32)
  and the conv's last ``K - 1`` inputs (model dtype) per layer: the whole
  "KV cache" of an SSM.
* The in/out projections go through ``layers.dense`` (K1 under a deployed
  plan).  The SSD products, the depthwise conv and the gated norm are
  activation x activation and stay plain PyTorch, as they stay plain
  ``jnp`` in the JAX package.

Each of the JAX code's three- and four-operand einsums is written as
explicit pairwise steps in the JAX expression's operand order, so the
summation order does not depend on which contraction path
``torch.einsum`` would pick on a given machine.  The dtype casts follow
the JAX code literally: the SSD in f32, the conv in the input's dtype,
silu in f32 then cast back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ``constrain`` sits at the JAX package's sites; it redistributes DTensors
# only, so on the mesh path (local tensors, distributed/spmd.py) it is inert.
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers


def init_mamba2(generator, d_model: int, cfg_ssm, dtype=torch.bfloat16, *,
                device="cpu") -> dict:
    di = cfg_ssm.d_inner(d_model)
    nh = cfg_ssm.n_heads(d_model)
    n = cfg_ssm.d_state
    g = 1  # B/C groups
    # Fused input projection: [z (gate), x, B, C, dt] like the reference impl.
    zxbcdt = di + di + 2 * g * n + nh
    in_proj = layers.init_dense(generator, d_model, zxbcdt, dtype,
                                device=device)
    conv_w = (layers._normal(generator, (cfg_ssm.conv_k, di + 2 * g * n),
                             device) * 0.2).to(dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(nh, generator=generator, device=generator.device,
                   dtype=torch.float32).to(device)
    out_proj = layers.init_dense(generator, di, d_model, dtype,
                                 scale=di ** -0.5, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di + 2 * g * n, dtype=torch.float32,
                              device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones(nh, dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "norm": layers.init_rmsnorm(di, device=device),
        "out_proj": out_proj,
    }


def mamba2_pspec() -> dict:
    return {
        "in_proj": layers.dense_pspec("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "a_log": (None,),
        "d_skip": (None,),
        "dt_bias": (None,),
        "norm": {"scale": ("ssm_inner",)},
        "out_proj": layers.dense_pspec("ssm_inner", "embed"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity past a threshold and rounds differently)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-tri cumulative sums: out[..., i, j] = sum_{j < k <= i} x[..., k]."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan.

    x: [B, S, H, P]; dt: [B, S, H]; a: [H] (negative decay rates);
    b, c: [B, S, G, N] with G == 1 (or [B, S, N]).
    Returns (y [B, S, H, P], final_state [B, H, P, N]).  ``S`` must be a
    multiple of ``chunk`` (the JAX package asserts it)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"SSD scan: sequence length {s} is not a multiple "
                         f"of the chunk {chunk}")
    nc = s // chunk

    # Reshape into chunks.
    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b.reshape(bsz, nc, chunk, n)      # G=1 squeezed
    cr = c.reshape(bsz, nc, chunk, n)

    da = dtr * a                            # [B, nc, L, H]  (negative)
    da_cum = torch.cumsum(da, dim=2)        # within-chunk cumulative decay

    # 1) intra-chunk (dual / attention-like) term
    l_kernel = torch.exp(_segsum(da.transpose(2, 3)))      # [B,nc,H,L,L]
    scores = cr @ br.transpose(2, 3)                        # bcln,bcmn->bclm
    # bchlm,bclm,bcmh,bcmhp->bclhp: L * scores * dt_m, then the m sum.
    wts = l_kernel * scores[:, :, None]
    wts = wts * dtr.transpose(2, 3)[:, :, :, None, :]
    y_diag = (wts @ xr.transpose(2, 3)).transpose(2, 3)    # [B,nc,L,H,P]
    del l_kernel, wts

    # 2) chunk states: state contribution of each chunk
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)   # [B,nc,L,H]
    # bcln,bclh,bclhp->bchpn: B_l (x) (dt * decay)_l, then the l sum.
    bd = br[:, :, :, None, :] * (dtr * decay_to_end)[..., None]
    states = xr.permute(0, 1, 3, 4, 2) @ bd.transpose(2, 3)   # [B,nc,H,P,N]

    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(torch.sum(da, dim=2))             # [B,nc,H]
    state = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    before = []                              # the state BEFORE each chunk
    for ci in range(nc):
        before.append(state)
        state = (state * chunk_decay[:, ci, :, None, None].float()
                 + states[:, ci].float())
    h_before = torch.stack(before, dim=1)                     # [B,nc,H,P,N]

    # 4) inter-chunk output: y_off = C_t . (decay_in * h_before)
    decay_in = torch.exp(da_cum)                              # [B,nc,L,H]
    # bcln,bclh,bchpn->bclhp: C_l (x) decay_l, then the n sum.
    cd = cr[:, :, :, None, :] * decay_in[..., None]           # [B,nc,L,H,N]
    y_off = (cd.transpose(2, 3)
             @ h_before.to(cr.dtype).transpose(3, 4)).transpose(2, 3)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, state


def ssd_decode_step(state, x, dt, a, b, c):
    """One-token recurrence.  state: [B,H,P,N]; x: [B,H,P]; dt: [B,H];
    b, c: [B,N].  Returns (y [B,H,P], new_state)."""
    decay = torch.exp(dt * a[None, :])                       # [B,H]
    # bn,bh,bhp->bhpn
    dbx = (b[:, None, :] * dt[:, :, None])[:, :, None, :] * x[..., None]
    new_state = state * decay[..., None, None] + dbx
    y = (new_state @ c[:, None, :, None])[..., 0]            # bhpn,bn->bhp
    return y, new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: [B, S, C]; w: [K, C].

    Returns (y [B, S, C], new_conv_state [B, K-1, C])."""
    k = w.shape[0]
    s = x.shape[1]
    if conv_state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = x_pad[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        y = y + x_pad[:, i:i + s] * w[i][None, None, :]
    new_state = x_pad[:, -(k - 1):] if k > 1 else None
    return y + bias.to(y.dtype), new_state


def mamba2_block(p: dict, x: torch.Tensor, cfg, *, state: dict | None = None,
                 mode=None, return_final_state: bool = False):
    """x: [B, S, d_model].  state (decode): {'ssm': [B,H,P,N], 'conv':
    [B,K-1,C]}.  Returns (y [B, S, d_model], new state or None).

    return_final_state (prefill): also return the post-sequence recurrent
    state so decode can continue from it.  A decode (``state`` given)
    reads the first token only, as in the JAX package."""
    cfg_ssm = cfg.ssm
    mode = mode or cfg.linear_mode
    bsz, s, d = x.shape
    di = cfg_ssm.d_inner(d)
    nh = cfg_ssm.n_heads(d)
    n = cfg_ssm.d_state
    pdim = cfg_ssm.headdim

    zxbcdt = layers.dense(p["in_proj"], x, mode, path="ssm/in_proj")
    zxbcdt = constrain(zxbcdt, {0: "batch"})
    # jnp.split(.., [di, 2 di + 2n]) takes indices; torch.split sizes.
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    conv_out, new_conv = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    xs, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # [B,S,H]
    dt = constrain(dt, {0: "batch", 2: "model"})
    a = -torch.exp(p["a_log"])                                 # [H] < 0

    xh = constrain(xs.reshape(bsz, s, nh, pdim), {0: "batch", 2: "model"})
    f32 = torch.float32
    new_state = None
    if state is None:
        y, final = ssd_chunked(xh.to(f32), dt, a, b.to(f32), c.to(f32),
                               min(cfg_ssm.chunk, s))
        if return_final_state:
            new_state = {"ssm": final, "conv": new_conv}
    else:
        y1, new_ssm = ssd_decode_step(
            state["ssm"], xh[:, 0].to(f32), dt[:, 0], a, b[:, 0].to(f32),
            c[:, 0].to(f32))
        y = y1[:, None]
        new_state = {"ssm": new_ssm, "conv": new_conv}
    y = y + xh.to(f32) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z.to(f32)).to(x.dtype)                     # gate
    y = layers.rmsnorm(p["norm"], y, cfg.norm_eps)
    return layers.dense(p["out_proj"], y, mode,
                        path="ssm/out_proj"), new_state


def init_mamba_state(batch: int, d_model: int, cfg_ssm,
                     dtype=torch.float32, *, device="cpu") -> dict:
    nh = cfg_ssm.n_heads(d_model)
    di = cfg_ssm.d_inner(d_model)
    return {
        "ssm": torch.zeros((batch, nh, cfg_ssm.headdim, cfg_ssm.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg_ssm.conv_k - 1,
                             di + 2 * cfg_ssm.d_state), dtype=dtype,
                            device=device),
    }
