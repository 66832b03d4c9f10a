"""Device resolution (counterpart of ``paddle_tpu/device/__init__.py`` and
``paddle_tpu/framework/place.py``).

The port runs on the card. An entry point resolves its ``device`` argument
here: ``None`` means CUDA, ``"cpu"`` is honoured only when asked for, and
a missing card raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None``/``"gpu"``/``"cuda[:i]"`` → that CUDA device (raises when
    CUDA is unavailable); ``"cpu"`` → the CPU. A ``torch.device`` passes
    through the same checks."""
    if device is None:
        device = "cuda"
    if isinstance(device, str) and device.lower().startswith("gpu"):
        device = "cuda" + device[3:]
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise ValueError(f"device {dev} out of range "
                         f"({torch.cuda.device_count()} CUDA devices)")
    return dev

