from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    SsdScan,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_workspace,
)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
