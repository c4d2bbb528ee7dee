"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means CUDA: the port's entry points run on the card unless
    the caller asks for another device (the CPU tests pass
    ``device="cpu"``). A CUDA request without a CUDA device raises --
    nothing falls back to the CPU. A bare ``"cuda"`` resolves to the
    current card's index, so placement memos key one device one way.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain version")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
