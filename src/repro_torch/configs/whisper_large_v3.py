"""whisper-large-v3 [audio]: enc-dec backbone; conv frontend is a STUB --
callers pass precomputed frame embeddings (``batch["frames"]``).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        arch_type="encdec",
        n_layers=32,            # decoder depth
        n_enc_layers=32,        # encoder depth
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        act="gelu",
        frontend="audio_stub",
    )
