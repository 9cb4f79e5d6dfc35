"""Config schema for models, training, serving, and the CiM feature."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    conv_k: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    qk_norm: bool = False
    sliding_window: int | None = None   # SWA width (h2o-danube)
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (t, h, w)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_attn_interval: int = 0       # zamba2: shared attn every N layers
    n_enc_layers: int = 0               # encdec: encoder depth
    frontend: str = "none"              # none | audio_stub | vision_stub
    act: str = "silu"                   # mlp activation: silu(glu) | gelu
    dtype: Any = "bfloat16"
    # CiM deployment policy: which linears run in which executor mode.
    linear_mode: str = "exact"          # exact | qat | w8a8 | cim
    # KV-cache storage dtype: 'bf16' or 'int8' (per-token-head scales —
    # the paper's static-quant machinery applied to the decode cache).
    kv_cache_dtype: str = "bf16"
    # Shard the residual stream's d_model over 'model' between blocks
    # (FSDP-style activation sharding): remat carry stacks shrink by the TP
    # degree at the cost of one per-layer activation all-gather.
    act_shard: bool = False
    # Sub-quadratic flag: can this arch serve 500k+ contexts?
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so the head shards evenly on
        any production mesh (padded logits are masked to -inf)."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab
        n = v * d  # token embedding
        if not self.tie_embeddings:
            n += v * d
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.act == "silu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        if self.arch_type == "moe":
            m = self.moe
            mlp = m.n_experts * 3 * d * m.d_ff_expert \
                + m.n_shared_experts * 3 * d * m.d_ff_expert + d * m.n_experts
            n += self.n_layers * (attn + mlp)
        elif self.arch_type == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            g = 1
            blk = d * (2 * di + 2 * g * s.d_state + nh) + di * d \
                + di * s.conv_k + 2 * nh
            n += self.n_layers * blk
        elif self.arch_type == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            blk = d * (2 * di + 2 * s.d_state + nh) + di * d + di * s.conv_k + 2 * nh
            n += self.n_layers * (blk + mlp_dense)
            n += attn + mlp_dense  # one shared attn block
        elif self.arch_type == "encdec":
            n += self.n_enc_layers * (attn + mlp_dense)      # encoder
            n += self.n_layers * (2 * attn + mlp_dense)      # dec: self+cross
        else:
            n += self.n_layers * (attn + mlp_dense)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.arch_type != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * m.n_experts * 3 * d * m.d_ff_expert
        active = self.n_layers * (m.top_k + m.n_shared_experts) * 3 * d * m.d_ff_expert
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1             # gradient accumulation
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots
    zero1: bool = True                # shard optimizer state over data axis
    grad_compression: bool = False    # int8 all-reduce w/ error feedback
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
