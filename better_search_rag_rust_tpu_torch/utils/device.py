"""The device a pipeline or trainer runs on."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the CPU
    runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
