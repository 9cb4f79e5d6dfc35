"""qwen2-vl-72b [vlm]: M-RoPE (t/h/w), dynamic resolution; vision tower is
a STUB -- callers pass pre-merged patch/token embeddings
(``batch["embeds"]``) and their [3, B, S] positions.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        arch_type="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        mrope_sections=(16, 24, 24),   # head_dim/2 = 64 = 16+24+24
        frontend="vision_stub",
    )
