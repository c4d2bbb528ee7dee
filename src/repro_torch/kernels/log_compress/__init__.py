from repro_torch.kernels.log_compress.ops import (  # noqa: F401
    compress,
    compression_factor,
    decompress,
)
from repro_torch.kernels.log_compress.ref import (  # noqa: F401
    compress_ref,
    decompress_ref,
)
