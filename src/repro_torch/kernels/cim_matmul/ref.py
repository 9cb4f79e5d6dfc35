"""Oracle for the fused W8A8 matmul kernel: the plain PyTorch version,
bit-exact semantics (exact int8 product, f32 epilogue)."""
from repro_torch.kernels.cim_matmul.ops import cim_matmul_plain as cim_matmul_ref  # noqa: F401
