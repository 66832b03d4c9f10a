"""``paddle.jit`` (counterpart of ``paddle_tpu/jit``): only ``InputSpec``
so far. ``to_static``, ``save``/``load`` and the dy2static lowering are
``ROADMAP.md`` Queue 1 item 10."""
from .save_load import InputSpec  # noqa: F401

__all__ = ["InputSpec"]
