"""Device selection shared by every public entry point of the port.

Entry points take an explicit ``device`` argument.  ``None`` means the
card: it resolves to ``cuda`` and raises when no CUDA device is
present, so a run never drops to the CPU without being asked.  The CPU
is used only when the caller passes ``device="cpu"`` (the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "F64"]

# every tensor factory of the port names its dtype: torch defaults to
# float32, and the reference cost model runs in float64 throughout
F64 = torch.float64


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raising without a card); anything else is
    taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
