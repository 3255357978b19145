"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: a CUDA
device requested where CUDA is missing is an error, never a silent move
to the host.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device` (a bare ``"cuda"`` resolves
    to the current card, so it compares equal to a tensor's device);
    raises when it names CUDA and ``torch.cuda.is_available()`` is
    false."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: the port "
                         "runs on 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
