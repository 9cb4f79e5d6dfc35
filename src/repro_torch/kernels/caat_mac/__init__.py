from repro_torch.kernels.caat_mac.ops import cim_macro_matmul  # noqa: F401
from repro_torch.kernels.caat_mac.ref import caat_mac_ref  # noqa: F401
