"""``paddle.vision`` (counterpart of ``paddle_tpu/vision``): the model zoo,
:mod:`.models`. ``transforms``, ``datasets``, ``ops`` and the image backend
are not ported yet (``ROADMAP.md``, Queue 1 item 13)."""
from . import models  # noqa: F401

__all__ = ["models"]
