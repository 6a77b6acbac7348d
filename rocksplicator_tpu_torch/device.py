"""Device resolution for the port's entry points.

Entry points default to the card. Without CUDA they raise: nothing in the
port quietly runs on the CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``. Raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the card "
            "by default; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
