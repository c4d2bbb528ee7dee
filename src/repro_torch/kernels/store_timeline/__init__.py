from repro_torch.kernels.store_timeline.ops import (store_timeline,
                                                     store_timeline_batch)
from repro_torch.kernels.store_timeline.ref import (store_timeline_batch_ref,
                                                     store_timeline_ref)

__all__ = ["store_timeline", "store_timeline_batch",
           "store_timeline_batch_ref", "store_timeline_ref"]
