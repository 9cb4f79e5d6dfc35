from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention,
    paged_prefill,
)
