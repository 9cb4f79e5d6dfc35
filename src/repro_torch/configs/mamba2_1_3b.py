"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  Constant-size state => long_500k runs."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        arch_type="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,              # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,                 # unused
        vocab=50280,
        ssm=SSMConfig(d_state=128, conv_k=4, expand=2, headdim=64, chunk=256),
        subquadratic=True,
    )
