"""Device resolution for the port's entry points, and device constants.

Every entry point takes ``device=None`` and runs on the card: ``None``
resolves to ``cuda``, and a missing card is an error. The CPU runs only
when the caller asks for it (``device='cpu'``, as the tests do); there is no
silent fallback.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``cuda``); raise if it names an absent card."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'multigrid_tpu_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run on the CPU")
    return device


_constants: dict[tuple, torch.Tensor] = {}


def constant(value, device: str | torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` for host data that never
    changes (a table, a base layout), made once per device and value and
    then reused: the copy to the card happens at the first call only, so a
    step that reads it can be captured in a CUDA graph (a copy from the host
    there would synchronize). The tensor is shared: never write to it. A
    tensor given is moved and cast as ``torch.as_tensor`` would."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    a = np.asarray(value)
    device = torch.device(device)
    key = (a.dtype.str, a.shape, a.tobytes(), device, dtype)
    if key not in _constants:
        _constants[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return _constants[key]
