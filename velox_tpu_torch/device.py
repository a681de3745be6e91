"""Device choice for the engine's entry points.

Every entry point that places data or runs a plan takes ``device=None`` and
resolves it here: ``None`` means the CUDA device and **raises** when there is
none, so a measurement can never silently run on the host.  Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
