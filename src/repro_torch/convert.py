"""Carry the JAX package's parameters and KV pages across to the port.

Inputs are the JAX trees with numpy leaves (``jax.tree.map(np.asarray,
tree)`` on the caller's side); this module never imports JAX.  bfloat16
leaves (``ml_dtypes.bfloat16`` numpy arrays) cross as 16-bit views, so
every bit survives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy leaf -> torch tensor (bfloat16 through a 16-bit view)."""
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
    per-layer dicts."""
    out = {}
    for key, node in tree.items():
        if key == "stack":
            blocks = node["blocks"]
            out[key] = {"blocks": [
                _convert(_unstack(blocks, i), device)
                for i in range(cfg.n_layers)]}
        else:
            out[key] = _convert(node, device)
    return out


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
