"""zamba2-2.7b [hybrid]: Mamba-2 backbone + weight-shared attention block
every 6 layers.  [arXiv:2411.15242; hf]  SSM state + 9 shared-attn KV caches
=> long_500k runs."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        ssm=SSMConfig(d_state=64, conv_k=4, expand=2, headdim=64, chunk=256),
        hybrid_attn_interval=6,
        subquadratic=True,
    )
