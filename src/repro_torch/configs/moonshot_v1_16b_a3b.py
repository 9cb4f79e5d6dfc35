"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,          # GQA kv=16 (full MHA KV)
        d_ff=1408,              # expert FFN width
        vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared_experts=2, capacity_factor=1.25),
    )
