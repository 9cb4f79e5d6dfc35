from repro_torch.kernels.cim_matmul.ops import cim_matmul  # noqa: F401
from repro_torch.kernels.cim_matmul.ref import cim_matmul_ref  # noqa: F401
