"""Mixture-of-Experts layer: top-k router + grouped capacity dispatch (port
of ``repro/models/moe.py``).

* One dispatch group per batch row; capacity (GShard) per group is
  ``max(1, int(T_g * top_k * cf / E))``, dropless (``>= T_g``) when
  ``T_g <= 4 E``.  Slots are numbered token-major, so the cumsum
  positions -- and so the tokens dropped at capacity -- are the JAX
  package's.  Dropped slots keep only the residual (their weight is 0).
* Dispatch and combine are gathers through an inverse map whose empty
  cells point at a zero pad row; the combine accumulates the ``top_k``
  slots one by one in the layer dtype.
* The router runs in float (the default deploy plan keeps ``*router*``
  exact) with an f32 softmax.  Deployed expert banks (``gate_q`` present)
  run W8A8: one activation scale per layer, per-expert per-channel weight
  scales, and the down bank's input quantized on one absmax over the whole
  ``[E, G*C, ff]`` buffer.  Their int8 products are exact; under the
  ``w8a8_kernel`` plan each bank product is one K1 launch per expert
  (``kernels/cim_matmul``), whose epilogue ``acc * (a_scale * w_scale)``
  is the reference's order.
* On a mesh (``distributed/spmd.py``) the banks may hold this rank's
  experts only (``spmd.ExpertShard``, experts on 'model'): the rank runs
  its experts' rows of the dispatch buffer, takes the down bank's
  activation scale as the max over every rank's experts, and
  all-gathers the outputs; the balance loss's means are over the global
  batch.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import quant
from repro_torch.distributed import spmd
# ``constrain`` sits at the JAX package's sites; it redistributes DTensors
# only, so on the mesh path (local tensors, distributed/spmd.py) it is inert.
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers


def init_moe(generator, d_model: int, cfg_moe, dtype=torch.bfloat16, *,
             device="cpu") -> dict:
    e = cfg_moe.n_experts
    dff = cfg_moe.d_ff_expert

    def expert_bank(shape, scale):
        return (layers._normal(generator, shape, device) * scale).to(dtype)

    p = {
        "router": layers.init_dense(generator, d_model, e, torch.float32,
                                    device=device),
        "gate": expert_bank((e, d_model, dff), d_model ** -0.5),
        "up": expert_bank((e, d_model, dff), d_model ** -0.5),
        "down": expert_bank((e, dff, d_model), dff ** -0.5),
    }
    if cfg_moe.n_shared_experts:
        p["shared"] = layers.init_mlp(
            generator, d_model, dff * cfg_moe.n_shared_experts, "silu",
            dtype, device=device)
    return p


def moe_pspec(cfg_moe) -> dict:
    p = {"router": layers.dense_pspec("embed", None),
         "gate": ("experts", "embed", None),
         "up": ("experts", "embed", None),
         "down": ("experts", None, "embed")}
    if cfg_moe.n_shared_experts:
        p["shared"] = layers.mlp_pspec("silu")
    return p


def int8_bmm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[E, C, K] int8 x [E, K, N] int8 -> exact int32 (float64
    accumulation: |sum| < 2**53)."""
    return torch.bmm(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.int32)


def bank_matmul(xq, w_q, a_s, w_scale, *, kernel: bool) -> torch.Tensor:
    """One deployed bank product with its epilogue: ``[E, C, K]`` int8
    codes x ``[E, K, N]`` int8 -> f32 ``acc * (a_s * w_scale[e])``.
    ``kernel`` runs one ``cim_matmul`` per expert (K1 on the card, its
    plain twin on the CPU); else one exact batched product."""
    if not kernel:
        return int8_bmm(xq, w_q).to(torch.float32) * (a_s * w_scale[:, None,
                                                                    :])
    from repro_torch.kernels.cim_matmul import ops as kops
    return torch.stack([kops.cim_matmul(xq[e], w_q[e], a_s, w_scale[e])
                        for e in range(w_q.shape[0])])


def _expert_ffn(p: dict, buf: torch.Tensor, dtype, *,
                kernel: bool = False) -> torch.Tensor:
    """buf [E, C', d] -> [E, C', d] through the per-expert SwiGLU bank.
    Expert weights rest FSDP-sharded ([E:model, d:data, ff:None]);
    ``spmd.localize`` gathers their d / ff dims for compute."""
    def gathered(w):
        return constrain(w, {0: "model", 1: None, 2: None})

    if "gate_q" in p:
        a_s = p["a_scale"]
        buf_q = quant.quantize(buf.to(torch.float32), a_s)
        g = bank_matmul(buf_q, gathered(p["gate_q"]), a_s, p["gate_scale"],
                        kernel=kernel)
        u = bank_matmul(buf_q, gathered(p["up_q"]), a_s, p["up_scale"],
                        kernel=kernel)
        h = g * torch.sigmoid(g) * u
        h_s = torch.clamp_min(spmd.batch_max(h.abs().amax(), p),
                              1e-6) / 127.0
        h_q = quant.quantize(h, h_s)
        out = bank_matmul(h_q, gathered(p["down_q"]), h_s,
                          p["down_scale"], kernel=kernel)
        return out.to(dtype)
    g = torch.einsum("ecd,edf->ecf", buf.to(dtype),
                     gathered(p["gate"]).to(dtype))
    u = torch.einsum("ecd,edf->ecf", buf.to(dtype),
                     gathered(p["up"]).to(dtype))
    h = torch.nn.functional.silu(g.to(torch.float32)).to(dtype) * u
    return torch.einsum("ecf,efd->ecd", h, gathered(p["down"]).to(dtype))


def moe(p: dict, x: torch.Tensor, cfg_moe, mode="exact", dtype=None
        ) -> tuple[torch.Tensor, dict]:
    """x [B, S, d] -> (y, aux).  One dispatch group per batch row.  ``aux``
    holds the Switch ``aux_loss``, ``overflow_frac`` and the slots'
    ``keep`` mask ``[B, S*top_k]``."""
    if dtype is None:
        dtype = x.dtype
    b, s, d = x.shape
    e, k = cfg_moe.n_experts, cfg_moe.top_k
    g, tg = b, s
    dev = x.device
    x = constrain(x, {0: "batch"})
    logits = layers.dense(p["router"], x, "exact", dtype=dtype,
                          path="moe/router").to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # [G, Tg, E]
    top_p, top_e = torch.topk(probs, k, dim=-1)               # [G, Tg, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # Load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e.
    me = spmd.batch_mean(probs.mean(dim=(0, 1)))
    ce = spmd.batch_mean(torch.zeros(e, dtype=torch.float32,
                                     device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(g * tg * k, device=dev))
        / (g * tg * k))
    aux_loss = e * torch.sum(me * ce)

    capacity = max(1, int(tg * k * cfg_moe.capacity_factor / e))
    if tg <= 4 * e:
        capacity = max(capacity, tg)          # small calls are dropless

    # Per-group positions, token-major slots.
    flat_e = constrain(top_e.reshape(g, tg * k), {0: "batch"})
    onehot = constrain(torch.nn.functional.one_hot(flat_e, e).to(
        torch.int32), {0: "batch"})
    pos_in_e = constrain(torch.cumsum(onehot, dim=1) - onehot,
                         {0: "batch"})
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = pos < capacity

    # Inverse map: buffer cell (e, c) <- the token of its slot, else the
    # pad row tg.
    slot_tok = flat_e * capacity + torch.where(keep, pos, 0)  # [G, Tg*k]
    src_tok = (torch.arange(tg * k, device=dev) // k)[None].expand(g, -1)
    inv = torch.full((g, e * capacity + 1), tg, dtype=torch.long,
                     device=dev)
    scatter_idx = torch.where(keep, slot_tok, e * capacity)   # spare cell
    inv.scatter_(1, scatter_idx, src_tok)
    inv = inv[:, :e * capacity]

    # Dispatch: per-group gather into [G, E, C, d] (pad row = zeros).
    xt_pad = torch.cat([x, torch.zeros(g, 1, d, dtype=x.dtype, device=dev)],
                       dim=1)
    buf = torch.gather(xt_pad, 1, inv[..., None].expand(-1, -1, d))
    buf = constrain(buf.reshape(g, e, capacity, d), {0: "batch"})
    # [G, E, C, d] -> [E, G*C, d]; each bank then runs one batched
    # product.  On a mesh a rank holds its batch rows' buffer for every
    # expert and runs its own experts' rows of it (spmd.ExpertShard);
    # gather_experts then all-gathers the outputs over 'model'.
    buf_e = constrain(buf.transpose(0, 1).reshape(e, g * capacity, d),
                      {0: "model"})
    if isinstance(p, spmd.ExpertShard):      # this rank's experts only
        n_local = (p["gate_q"] if "gate_q" in p else p["gate"]).shape[0]
        buf_e = buf_e[p.lo:p.lo + n_local]
    kernel = backend_lib.resolve_backend(mode, "moe") == "w8a8_kernel"
    out_e = _expert_ffn(p, buf_e, dtype, kernel=kernel)       # [E, G*C, d]
    if isinstance(p, spmd.ExpertShard):
        out_e = spmd.gather_experts(out_e, p)
    out_e = constrain(out_e, {0: "model"})
    out_flat = constrain(out_e.reshape(e, g, capacity, d).transpose(
        0, 1).reshape(g, e * capacity, d), {0: "batch"})

    # Combine: each token's k expert outputs, slot by slot, in dtype.
    y = torch.zeros((g, tg, d), dtype=dtype, device=dev)
    slots = slot_tok.reshape(g, tg, k)
    kept = keep.reshape(g, tg, k)
    for slot in range(k):
        w_slot = (top_p[..., slot] * kept[..., slot]).to(dtype)
        picked = torch.gather(out_flat, 1, slots[..., slot, None].expand(
            -1, -1, d))
        y = y + picked.to(dtype) * w_slot[..., None]

    if "shared" in p:
        y = y + layers.mlp(p["shared"], x, "silu", mode, dtype,
                           path="moe/shared")
    aux = {"aux_loss": aux_loss,
           "overflow_frac": 1.0 - keep.to(torch.float32).mean(),
           "keep": keep}
    return y.reshape(b, s, d).to(x.dtype), aux
