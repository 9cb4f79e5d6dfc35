"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]  SWA => long_500k runs (O(window) ring cache)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        arch_type="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab=32000,
        sliding_window=4096,
        subquadratic=True,      # decode cost bounded by the window
    )
