"""Carry the JAX package's parameters, KV pages, sampler keys, sampled
chips and fine-tunes across to the port.

Inputs are the JAX trees with numpy leaves (``jax.tree.map(np.asarray,
tree)`` on the caller's side); this module never imports JAX.  bfloat16
leaves (``ml_dtypes.bfloat16`` numpy arrays) cross as 16-bit views, so
every bit survives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import calibration, quant


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy leaf -> torch tensor (bfloat16 through a 16-bit view); a
    tensor (a leaf read by ``CheckpointManager.load_flat``) is copied to
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return tensor_from_numpy(node, device)


def _unstack(node, i):
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i]


def params_from_jax(tree, cfg, *, device="cpu") -> dict:
    """The JAX package's model parameters (master or frozen: ``w`` or
    ``w_q``/``w_scale``/``a_scale`` leaves) -> the port's parameters.  The
    ``[L, ...]`` layer stack under ``stack/blocks`` becomes a list of
    per-layer dicts: a MoE layer's router, its expert banks (master
    ``gate``/``up``/``down`` ``[E, K, N]``, or frozen ``{..}_q`` with
    ``{..}_scale`` ``[E, N]``) and its ``a_scale`` (a scalar, from the
    JAX stack's ``[L]``) come out of the same slicing.  An encdec stack's
    ``encoder`` unstacks by ``n_enc_layers`` and its ``decoder`` by
    ``n_layers``.  Every other key of ``stack`` (a hybrid's
    ``shared_attn`` block) crosses as it is."""
    depth = {"blocks": cfg.n_layers, "decoder": cfg.n_layers,
             "encoder": cfg.n_enc_layers}
    out = {}
    for key, node in tree.items():
        if key == "stack":
            out[key] = {
                name: ([_convert(_unstack(sub, i), device)
                        for i in range(depth[name])]
                       if name in depth else _convert(sub, device))
                for name, sub in node.items()}
        else:
            out[key] = _convert(node, device)
    return out


def train_state_from_jax(flat: dict, cfg, *, device="cpu"
                         ) -> tuple[dict, dict]:
    """A JAX training checkpoint's ``{"params", "opt"}`` tree by path
    (``CheckpointManager.load_flat`` of a step the JAX package's
    ``train_loop.run`` saved: ``params/stack/blocks/attn/q/w`` stacked
    ``[L, ...]``, ``opt/{master,m,v}/...`` the same tree in f32,
    ``opt/step``) -> the port's ``(params, opt_state)``: every tree
    through :func:`params_from_jax`, ``step`` an int32 0-d tensor."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    opt = {k: params_from_jax(tree["opt"][k], cfg, device=device)
           for k in ("master", "m", "v")}
    opt["step"] = tensor_from_numpy(tree["opt"]["step"], device).to(
        torch.int32)
    return params_from_jax(tree["params"], cfg, device=device), opt


def pages_from_jax(pages, *, device="cpu") -> dict:
    """The JAX package's pool ``{"k", "v"}`` (arrays, or QTensors with
    ``.q``/``.scale`` leaves) -> the port's pool, same layout."""
    out = {}
    for name, leaf in pages.items():
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            out[name] = quant.QTensor(tensor_from_numpy(leaf.q, device),
                                      tensor_from_numpy(leaf.scale, device))
        else:
            out[name] = tensor_from_numpy(leaf, device)
    return out


def key_from_jax(key_data, *, device="cpu") -> torch.Tensor:
    """A JAX PRNG key's data (``np.asarray(jax.random.key_data(k))``,
    ``uint32[..., 2]``) -> the port's sampler key (``prng.py``):
    the same two words as an int64 tensor, so draws from it equal JAX's
    bit for bit."""
    return prng.as_key(np.asarray(key_data, dtype=np.uint32), device)


def chip_from_jax(sample, *, device="cpu") -> dict:
    """The JAX package's ``MacroSample`` (``{"caat": {...}, "adc":
    {"inl_lut": ...}}``, numpy leaves) -> the port's chip, its arrays as
    they are (the port's ``sample_chip`` at the same key is within 2 f32
    ulp of 1.0 of it: the ADC bow goes through ``sin``)."""
    return {"caat": _convert(dict(sample["caat"]), device),
            "adc": _convert(dict(sample["adc"]), device)}


def finetune_from_jax(ft, *, device="cpu"):
    """A JAX ``FineTuneParams`` (array-like gain and offset) -> the
    port's."""
    return calibration.FineTuneParams(
        gain=tensor_from_numpy(ft.gain, device),
        offset=tensor_from_numpy(ft.offset, device))


def vgg_params_from_jax(layers, *, device="cpu") -> list[dict]:
    """The JAX package's VGG-8 layer list (per-layer dicts with numpy
    leaves), master (``w``, ``b``) or frozen (``w_q``, ``w_scale``,
    ``a_scale``, ``b``, ``v_fs_mac``, ``ft_gain``, ``ft_offset``,
    ``plane_fs``, a nested ``chip``) -> the port's list."""
    out = []
    for layer in layers:
        p = {k: tensor_from_numpy(v, device) for k, v in layer.items()
             if k != "chip"}
        if "chip" in layer:
            p["chip"] = chip_from_jax(layer["chip"], device=device)
        out.append(p)
    return out
