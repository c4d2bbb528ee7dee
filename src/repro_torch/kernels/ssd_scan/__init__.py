from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401
    ssd_bwd_ref, ssd_priors_ref, ssd_ref)
