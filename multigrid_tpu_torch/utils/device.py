"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on the card: ``None``
resolves to ``cuda``, and a missing card is an error. The CPU runs only
when the caller asks for it (``device='cpu'``, as the tests do); there is no
silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``cuda``); raise if it names an absent card."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'multigrid_tpu_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run on the CPU")
    return device
