from repro_torch.kernels.moe_gmm.ops import (  # noqa: F401
    MoeGmm,
    moe_gmm,
    moe_gmm_bwd,
)
from repro_torch.kernels.moe_gmm.ref import (  # noqa: F401
    moe_gmm_bwd_ref,
    moe_gmm_ref,
)
