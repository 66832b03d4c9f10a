"""``InputSpec`` (the port's copy of ``paddle_tpu/jit/save_load.py``'s).
The rest of the file (``save``, ``load``, ``TranslatedLayer``) is
``ROADMAP.md`` Queue 1 item 10."""
from __future__ import annotations

from ..framework.dtype import to_torch_dtype

__all__ = ["InputSpec"]


class InputSpec:
    """``paddle.static.InputSpec``: a shape (a ``None`` or negative dim
    becomes 1), a dtype (a ``torch.dtype``) and a name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(int(s) if s is not None and s >= 0 else 1
                           for s in shape)
        self.dtype = to_torch_dtype(dtype)
        self.name = name
