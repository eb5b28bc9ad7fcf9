"""Device resolution shared by every entry point of the port.

Entry points default to ``device="cuda"``. A caller that wants the CPU asks
for it; nothing probes for a card and quietly falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
