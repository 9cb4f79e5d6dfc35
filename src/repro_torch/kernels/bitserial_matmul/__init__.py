from repro_torch.kernels.bitserial_matmul.ops import bitserial_matmul  # noqa: F401
from repro_torch.kernels.bitserial_matmul.ref import bitserial_matmul_ref  # noqa: F401
