"""qwen3-8b [dense]: qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab=151936,
        qk_norm=True,
    )
