"""The port's one device rule, shared by every entry point that touches a
device: ``device=None`` means ``cuda``, and there is no silent CPU
fallback."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``.  A CUDA
    device without a card raises - there is no silent CPU fallback; pass
    ``device="cpu"`` to run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the host")
    return dev
