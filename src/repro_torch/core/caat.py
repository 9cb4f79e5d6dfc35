"""Charge-domain analog adder tree (CAAT) behavioural model (port of
``repro/core/caat.py``).

The CAAT combines the 81 in-column charge-sharing results of one macro:
in-column (the M active rows average onto the source line), in-bank (the
9 column outputs of a bank merge through the hybrid binary/C-2C ladder)
and in-array (the 9 bank outputs merge with the activation-bit ladder).
Charge redistribution computes weighted averages, so the ideal root
voltage is A.W / (M * W_SUM * A_SUM).  A chip sample carries capacitor
mismatch (Pelgrom), C-2C stage attenuation, and per-bank / root gain and
offset errors.

``sample_caat`` draws at a ``prng`` key the chip that the JAX
package draws at that key (its normals bit for bit; a ``[..., 2]`` batch
of keys draws a batch of chips); ``convert.chip_from_jax`` carries a JAX
chip's arrays across.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import numerics


@dataclasses.dataclass(frozen=True)
class CaatConfig:
    """Static description of the adder tree."""

    n_act_bits: int = 9            # banks (one per activation bit)
    n_w_bits: int = 9              # columns per bank (one per weight bit)
    n_binary_msbs: int = 4         # top bits on binary-weighted caps
    sigma_unit: float = 0.0        # relative mismatch of a unit capacitor
    c2c_stage_gamma: float = 0.0   # per-C-2C-stage parasitic attenuation
    gain_sigma: float = 0.0        # global gain error std (per bank / root)
    offset_sigma: float = 0.0      # additive offset std, fraction of FS

    @property
    def act_weights(self) -> np.ndarray:
        return numerics.bit_weights(self.n_act_bits - 1)

    @property
    def w_weights(self) -> np.ndarray:
        return numerics.bit_weights(self.n_w_bits - 1)


# A chip sample: effective (mismatched) weights and offsets, f32 tensors.
CaatSample = dict[str, Any]


def _mismatched_weights(eps: torch.Tensor, nominal: np.ndarray,
                        cfg: CaatConfig) -> torch.Tensor:
    """Pelgrom mismatch (``eps`` standard normal, one per capacitor of
    the ladder's last axis) + C-2C stage attenuation on one ladder, in
    JAX's f32 steps (its ``sqrt`` correctly rounded, through float64)."""
    nominal = torch.as_tensor(nominal, dtype=torch.float32,
                              device=eps.device)
    w_min = float(nominal.min())
    sigma = cfg.sigma_unit / torch.sqrt(
        (nominal / w_min).to(torch.float64)).to(torch.float32)
    n = nominal.shape[-1]
    depth = torch.clamp_min(
        torch.arange(n, device=eps.device) - (cfg.n_binary_msbs - 1), 0)
    atten = torch.as_tensor(np.float32(1.0 - cfg.c2c_stage_gamma)
                            ** depth.cpu().numpy().astype(np.float32),
                            device=eps.device)
    return nominal * (1.0 + eps * sigma) * atten


def sample_caat(key, cfg: CaatConfig) -> CaatSample:
    """Draw one fabricated chip's CAAT: at a ``prng`` key (JAX's
    split order: bank, root, bank gain, root gain, bank offset, root
    offset; one key per bank ladder) on the key's device."""
    keys = prng.split(prng.as_key(key), 6).unbind(-2)
    bank_eps = prng.normal(prng.split(keys[0], cfg.n_act_bits),
                           (cfg.n_w_bits,))
    root_eps = prng.normal(keys[1], (cfg.n_act_bits,))
    gain_b, gain_r, off_b, off_r = (
        prng.normal(k, s) for k, s in zip(
            keys[2:], ((cfg.n_act_bits,), (), (cfg.n_act_bits,), ())))
    return {
        "bank_w": _mismatched_weights(bank_eps, cfg.w_weights, cfg),
        "root_w": _mismatched_weights(root_eps, cfg.act_weights, cfg),
        "bank_gain": 1.0 + cfg.gain_sigma * gain_b,
        "root_gain": 1.0 + cfg.gain_sigma * gain_r,
        "bank_off": cfg.offset_sigma * off_b,
        "root_off": cfg.offset_sigma * off_r,
    }


def ideal_caat(cfg: CaatConfig, device="cpu") -> CaatSample:
    """The mismatch-free chip."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "bank_w": torch.as_tensor(cfg.w_weights, **f32).repeat(
            cfg.n_act_bits, 1),
        "root_w": torch.as_tensor(cfg.act_weights, **f32),
        "bank_gain": torch.ones(cfg.n_act_bits, **f32),
        "root_gain": torch.ones((), **f32),
        "bank_off": torch.zeros(cfg.n_act_bits, **f32),
        "root_off": torch.zeros((), **f32),
    }


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly in index order: the same f32
    result on every device (and, for the 9-entry ladders, the same as the
    JAX package's reductions)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _weighted_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i x[..., i] * w[..., i] in w's dtype, strictly in index order,
    without a converted copy of x or a product temporary."""
    acc = x[..., 0].to(w.dtype) * w[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i].to(w.dtype) * w[..., i]
    return acc


def caat_combine(v_col: torch.Tensor, sample: CaatSample) -> torch.Tensor:
    """Two-level charge-redistribution combine.  v_col: [..., n_act_bits,
    n_w_bits] in-column averages in [-1, 1].  Returns the CAAT-R voltage
    [...] (f32), normalized so the ideal value is A.W / (M * A_SUM *
    W_SUM).

    The combine runs in float64 (pass float64 ``v_col`` to keep the
    in-column averages exact too) and rounds once to f32.  The column
    averages are O(1) while the root voltage of a mostly padded row tile
    (VGG-8's conv1 drives 27 of 1152 rows, fc1's last tile 128) cancels to
    O(1e-3) of that, so an f32 combine -- the JAX package's -- keeps only
    ~4 significant digits of the signal there and moves ~1e-4 of the ADC
    codes by one against the exactly rounded voltage.
    """
    f64 = {k: v.to(torch.float64) for k, v in sample.items()}
    v_bank = _weighted_sum(v_col, f64["bank_w"]) / _seq_sum(f64["bank_w"])
    v_bank = v_bank * f64["bank_gain"] + f64["bank_off"]
    v_root = _weighted_sum(v_bank, f64["root_w"]) / _seq_sum(f64["root_w"])
    return (v_root * f64["root_gain"] + f64["root_off"]).to(torch.float32)


def caat_transfer(codes: torch.Tensor, sample: CaatSample, cfg: CaatConfig
                  ) -> torch.Tensor:
    """Static transfer curve: drive the tree with each code's bit pattern
    (single row, weight +1); the root voltage per code."""
    a_bits = numerics.encode_pm1(codes, cfg.n_act_bits - 1).to(torch.float32)
    w_bits = numerics.encode_pm1(torch.ones_like(codes),
                                 cfg.n_w_bits - 1).to(torch.float32)
    v_col = a_bits[..., :, None] * w_bits[..., None, :]
    return caat_combine(v_col, sample)


def caat_inl(sample: CaatSample, cfg: CaatConfig) -> np.ndarray:
    """INL of the static transfer curve, in LSB at 8b, endpoint
    corrected."""
    codes = torch.arange(-128, 128, device=sample["root_w"].device)
    v = caat_transfer(codes, sample, cfg).cpu().numpy().astype(np.float64)
    x = np.arange(v.size, dtype=np.float64)
    slope = (v[-1] - v[0]) / (x[-1] - x[0])
    line = v[0] + slope * x
    lsb = (v[-1] - v[0]) / (v.size - 1)
    return (v - line) / lsb


def caat_effective_bits(sample: CaatSample, cfg: CaatConfig) -> float:
    """Summation accuracy in bits: 8 - log2(2 * max|INL|) (Fig. 9a)."""
    max_inl = float(np.max(np.abs(caat_inl(sample, cfg))))
    if max_inl <= 0.5:
        return 8.0
    return 8.0 - float(np.log2(2.0 * max_inl))


def effective_linear_weights(sample: CaatSample
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse the two-level tree into one linear map over the 81
    planes: v_root = sum_{k,i} W_eff[k,i] * v_col[..., k, i] + offset.
    Folding W_eff into the activation bits turns the 81-plane reduction
    into nine weighted-plane matmuls (the caat_mac kernel's form).

    Returned in float64, like :func:`caat_combine`'s arithmetic: the
    padded rows of a row tile all carry the same folded value, so an f32
    W_eff's rounding would add up over hundreds of rows."""
    s = {k: v.to(torch.float64) for k, v in sample.items()}
    bank_coeff = s["bank_w"] / _seq_sum(s["bank_w"])[:, None]
    root_coeff = s["root_w"] / _seq_sum(s["root_w"])
    w_eff = (root_coeff[:, None] * s["bank_gain"][:, None]
             * bank_coeff) * s["root_gain"]
    offset = (_seq_sum(root_coeff * s["bank_off"]) * s["root_gain"]
              + s["root_off"])
    return w_eff, offset


# Area model (Fig. 7a): total capacitance of one CAAT-L, binary vs hybrid.

def capacitor_total_binary(n_bits: int) -> float:
    """Fully binary-weighted summing network for one (n_bits+1)-column
    leaf, smallest cap 4C for matching (the paper's ~1032C at 8b)."""
    w = numerics.bit_weights(n_bits)
    scale = 4.0 / float(np.min(w))
    return float(np.sum(w) * scale) + 2.0  # + dummy/edge caps


def capacitor_total_hybrid(n_bits: int, n_binary_msbs: int = 4) -> float:
    """Hybrid binary + C-2C CAAT-L (the paper's design, 96C at 8b)."""
    n_cols = n_bits + 1
    per_line_load = 9.0 * n_cols
    n_c2c = max(n_cols - n_binary_msbs, 0)
    return per_line_load + 3.0 * n_c2c
