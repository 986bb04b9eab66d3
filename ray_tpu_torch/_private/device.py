"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and without CUDA it is an error rather
than a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else is
    passed to ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run on the "
                "CPU")
        return torch.device("cuda")
    return torch.device(device)
