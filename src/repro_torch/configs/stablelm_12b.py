"""stablelm-12b [dense].  [hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        arch_type="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab=100352,
    )
