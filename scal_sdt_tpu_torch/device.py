"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. A caller that
wants the CPU says so (the tests do); a missing card is an error, never a
quiet fall-back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
