"""Device selection: the port runs on ``cuda`` unless told otherwise.

Every entry point takes an optional ``device``; ``None`` means the first
CUDA device. A CPU device must be asked for explicitly (the tests do), and
asking for CUDA on a machine without one raises instead of quietly running
on the CPU.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (explicitly or by default) and there is none."""


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The torch device an entry point runs on (``cuda`` by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "xaynet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
