"""Places (counterpart of ``paddle_tpu/framework/place.py``).

A place names where the facade's tensors live: ``CPUPlace`` or
``CUDAPlace(i)``. ``TPUPlace`` stays as a name for the card, so code
written for the JAX package runs unchanged. The current place defaults to
the card; ``set_device("cpu")`` moves it to the CPU. A CUDA place without
a card raises (:func:`~paddle_tpu_torch.device.resolve_device`), when it is
set or first used; nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "to_torch_device"]


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


# the JAX package's accelerator place: here, the card
TPUPlace = CUDAPlace

_current_place: Place | None = None


def is_compiled_with_cuda() -> bool:
    """True: the port is the CUDA build (the JAX package says False)."""
    return True


def is_compiled_with_tpu() -> bool:
    return False


def _get_current_place() -> Place:
    """The current place; the card unless ``set_device`` said otherwise.
    Touches no device."""
    return _current_place if _current_place is not None else CUDAPlace(0)


def get_device() -> str:
    p = _get_current_place()
    if isinstance(p, CPUPlace):
        return "cpu"
    return f"gpu:{p.device_id}"


def set_device(device) -> Place:
    """``paddle.device.set_device``: ``"cpu"``, ``"gpu"``/``"gpu:i"``
    (also ``"cuda"``, ``"tpu"``) or a Place. A CUDA place raises when no
    card is present."""
    global _current_place
    if isinstance(device, Place):
        place = device
    else:
        s = str(device).lower()
        if s == "cpu":
            place = CPUPlace()
        else:
            kind, _, idx = s.partition(":")
            if kind not in ("gpu", "cuda", "tpu"):
                raise ValueError(f"unsupported device {device!r}")
            place = CUDAPlace(int(idx) if idx else 0)
    to_torch_device(place)          # raises for a card that is not there
    _current_place = place
    return place


def to_torch_device(place: Place | None = None) -> torch.device:
    """A place (the current one for ``None``) → ``torch.device``."""
    place = place if place is not None else _get_current_place()
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    return resolve_device(f"cuda:{place.device_id}")


def place_of(dev: torch.device) -> Place:
    """The place of a ``torch.device``."""
    if dev.type == "cpu":
        return CPUPlace()
    return CUDAPlace(dev.index or 0)


def device_count() -> int:
    return torch.cuda.device_count()
