"""VGG-8 (the paper's CIFAR-10/100 model) with CiM-offloaded layers (port
of ``repro/models/vgg.py``).

Six 3x3 conv layers (128,128 | 256,256 | 512,512, a 2x2 maxpool after
every second) and two FC layers.  Convolutions are lowered to im2col +
matmul so every layer runs through the LinearExecutor and its backends.
Activations keep the JAX package's NHWC layout, so both packages compare
like with like.  conv2's K = 9 * 128 = 1152 is exactly the macro's row
count; deeper layers split into 2, 4 or 8 row tiles.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import executor, macro, quant

VGG8_CHANNELS = (128, 128, 256, 256, 512, 512)
POOL_AFTER = (False, True, False, True, False, True)
# Logical layer paths for DeploymentPlan pattern matching.
VGG8_LAYER_PATHS = ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6",
                    "fc1", "head")


def resolve_specs(cfg: "Vgg8Config", mode=None) -> list:
    """Layer specs with modes resolved from a mode string or a
    DeploymentPlan (patterns match VGG8_LAYER_PATHS, e.g. 'conv*')."""
    specs = cfg.layer_specs()
    if mode is None:
        return specs
    plan = backend_lib.as_plan(mode)
    out = []
    for s, p in zip(specs, VGG8_LAYER_PATHS):
        rule = plan.rule_for(p)
        out.append(dataclasses.replace(
            s, mode=rule.backend,
            plane_adc_bits=rule.plane_adc_bits or s.plane_adc_bits))
    return out


@dataclasses.dataclass(frozen=True)
class Vgg8Config:
    n_classes: int = 10
    image_size: int = 32
    fc_dim: int = 1024
    mode: str = "exact"
    macro_rows: int = 1152

    def layer_specs(self) -> list:
        mcfg = macro.nominal_config(rows=self.macro_rows)
        specs = []
        cin = 3
        for cout in VGG8_CHANNELS:
            specs.append(executor.LinearSpec(
                in_dim=9 * cin, out_dim=cout, use_bias=True, relu=True,
                mode=self.mode, macro=mcfg))
            cin = cout
        flat = (self.image_size // 8) ** 2 * VGG8_CHANNELS[-1]
        specs.append(executor.LinearSpec(
            in_dim=flat, out_dim=self.fc_dim, use_bias=True, relu=True,
            mode=self.mode, macro=mcfg))
        specs.append(executor.LinearSpec(
            in_dim=self.fc_dim, out_dim=self.n_classes, use_bias=True,
            relu=False, mode=self.mode, macro=mcfg))
        return specs


def init_vgg8(gen: torch.Generator, cfg: Vgg8Config) -> list[dict]:
    """Master parameters of the 8 layers, drawn on ``gen``'s device."""
    return [executor.init(gen, s) for s in cfg.layer_specs()]


def _im2col(x):
    """[B, H, W, C] -> [B, H, W, 9C] patches (3x3, SAME padding).
    QTensor-safe: symmetric int8 has zero zero-point, so padding the codes
    with 0 is padding the values with 0.0."""
    if isinstance(x, quant.QTensor):
        return quant.QTensor(_im2col(x.q), x.scale)
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)]
    return torch.cat(cols, dim=-1)


def _maxpool2(x):
    """2x2 max pool; QTensor-safe (max over codes == max over values)."""
    if isinstance(x, quant.QTensor):
        return quant.QTensor(_maxpool2(x.q), x.scale)
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _reshape(x, *shape):
    if isinstance(x, quant.QTensor):
        return quant.QTensor(x.q.reshape(*shape), x.scale)
    return x.reshape(*shape)


def _f32(x):
    return x if isinstance(x, quant.QTensor) else x.to(torch.float32)


def vgg8_forward(params: list[dict], images: torch.Tensor, cfg: Vgg8Config,
                 *, mode=None, a_scales: list | None = None,
                 chips: list | None = None, stats: list | None = None
                 ) -> torch.Tensor:
    """Logits [B, n_classes] of NHWC images.  ``mode`` is a backend name or
    a DeploymentPlan with per-layer rules.

    With a residency plan and frozen params each layer's epilogue
    requantizes straight onto the next layer's activation grid and the
    conv->relu->pool->conv chain stays int8 (a QTensor threads through
    im2col and maxpool), bit-identical to the non-resident path.  When
    ``stats`` is a list, each layer's conversion accounting is appended
    to it."""
    specs = resolve_specs(cfg, mode)
    resident = backend_lib.residency_enabled(mode)

    def chain_scale(li: int):
        """The next layer's activation grid, when this layer can requantize
        onto it in its epilogue and the next layer is deployed int8."""
        if not resident or li + 1 >= len(params):
            return None
        nxt = params[li + 1]
        if "w_q" not in params[li] or not isinstance(nxt, dict) \
                or "a_scale" not in nxt:
            return None
        bk = backend_lib.get_backend(specs[li].mode)
        return nxt["a_scale"] if (bk.frozen and bk.supports_out_requant) \
            else None

    def layer(li, x):
        y, st = executor.apply(
            params[li], x, specs[li],
            a_scale=None if a_scales is None else a_scales[li],
            chip=None if chips is None else chips[li], return_stats=True,
            out_scale=chain_scale(li))
        if stats is not None:
            stats.append(st)
        return y

    x = images
    li = 0
    for conv_i, cout in enumerate(VGG8_CHANNELS):
        patches = _im2col(x)
        b, h, w, pdim = patches.shape
        y = layer(li, _reshape(patches, b * h * w, pdim))
        x = _f32(_reshape(y, b, h, w, cout))
        if POOL_AFTER[conv_i]:
            x = _maxpool2(x)
        li += 1
    x = _f32(layer(li, _reshape(x, x.shape[0], -1)))
    logits = layer(li + 1, x)
    return logits.to(torch.float32)


def _exact_stream(params, images, cfg, visit):
    """The exact-mode forward, calling ``visit(li, flat_input)`` with
    every layer's flattened input before the layer runs."""
    specs = cfg.layer_specs()
    x = images
    li = 0
    for conv_i, cout in enumerate(VGG8_CHANNELS):
        patches = _im2col(x)
        b, h, w, pdim = patches.shape
        flat = patches.reshape(b * h * w, pdim)
        visit(li, flat)
        spec = dataclasses.replace(specs[li], mode="exact")
        y = executor.apply(params[li], flat, spec)
        x = y.reshape(b, h, w, cout).to(torch.float32)
        if POOL_AFTER[conv_i]:
            x = _maxpool2(x)
        li += 1
    x = x.reshape(x.shape[0], -1)
    for li in (6, 7):
        visit(li, x)
        spec = dataclasses.replace(specs[li], mode="exact")
        x = executor.apply(params[li], x, spec).to(torch.float32)


def collect_activation_scales(params, images, cfg) -> list[torch.Tensor]:
    """One calibration pass in exact mode; static per-layer a_scales."""
    scales = []
    _exact_stream(params, images, cfg,
                  lambda li, flat: scales.append(quant.absmax_scale(flat)))
    return scales


def calibrate_v_fs(params, cfg: Vgg8Config, a_scales, images,
                   q: float = 0.999, margin: float = 1.15) -> list[float]:
    """Per-layer analog full scale from measured per-row-tile partial-sum
    MACs: quantize the calibration activations and weights, take every
    row tile's integer partial sums, a high quantile x margin."""
    specs = cfg.layer_specs()
    v_fs = []

    def layer_vfs(li, flat):
        a_q = quant.quantize(flat.to(torch.float32), a_scales[li])
        w = params[li]["w"].to(torch.float32)
        w_q = quant.quantize(w, quant.absmax_scale(w, axis=0))
        rows = specs[li].macro.rows
        k = w_q.shape[0]
        n_tiles = -(-k // rows)
        pad = n_tiles * rows - k
        a_p = torch.nn.functional.pad(a_q.to(torch.float64), (0, pad))
        w_p = torch.nn.functional.pad(w_q.to(torch.float64), (0, 0, 0, pad))
        # Integer partial sums, exact in float64: [T, B, N].
        parts = torch.einsum(
            "btr,trn->tbn", a_p.reshape(a_p.shape[0], n_tiles, rows),
            w_p.reshape(n_tiles, rows, -1))
        # torch.quantile takes at most 2**24 elements; at the 32
        # calibration images of the deploy flow the largest layer has
        # 32768 x 128 ~ 4.2M.
        absparts = parts.abs().to(torch.float32).reshape(-1)
        v_fs.append(float(torch.quantile(absparts, q)) * margin)

    _exact_stream(params, images, cfg, layer_vfs)
    return v_fs


def freeze_vgg8(params, cfg: Vgg8Config, a_scales, *, chips=None,
                finetunes=None, mode="w8a8", v_fs_list=None) -> list[dict]:
    """Deploy: every layer to its frozen int8 / cim form.  ``mode`` is a
    backend name or a DeploymentPlan over VGG8_LAYER_PATHS.  For 'cim'
    layers pass v_fs_list from :func:`calibrate_v_fs` (the fallback
    fixed-utilization heuristic is known-poor on trained networks)."""
    specs = resolve_specs(cfg, mode)
    frozen = []
    for i, (p, s) in enumerate(zip(params, specs)):
        v_fs = None
        if s.mode == "cim":
            if v_fs_list is not None:
                v_fs = v_fs_list[i]
            else:
                v_fs = 0.35 * 127.0 * 127.0 * min(s.in_dim, s.macro.rows)
        frozen.append(executor.freeze(
            p, s, a_scales[i], chip=None if chips is None else chips[i],
            finetune=None if finetunes is None else finetunes[i],
            v_fs_mac=v_fs))
    return frozen
