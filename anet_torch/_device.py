"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch.device for an entry point's ``device=`` argument.

    Entry points default to ``"cuda"`` and never fall back to the CPU: when
    CUDA is absent this raises unless the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (numpy array, sequence or tensor) as a tensor on the resolved
    ``device``; a tensor already there is returned without a copy."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
