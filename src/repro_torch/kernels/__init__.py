"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``) and a dispatcher (``ops.py``)."""

from __future__ import annotations

import contextlib
from typing import Iterator

#: Whether the models send a meta tensor through the kernels' shape-only
#: ops (``flash_attn.ops.flash_attention_meta``,
#: ``ssd_scan.ops.ssd_scan_meta``: one op a launch) instead of their
#: plain versions: ``launch/costing.py``'s kernel accounting.
ON_META = False


@contextlib.contextmanager
def on_meta(on: bool = True) -> Iterator[None]:
    """Set :data:`ON_META` to ``on`` inside the block."""
    global ON_META
    saved, ON_META = ON_META, bool(on)
    try:
        yield
    finally:
        ON_META = saved
