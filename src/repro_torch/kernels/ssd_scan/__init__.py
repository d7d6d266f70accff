from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: F401
