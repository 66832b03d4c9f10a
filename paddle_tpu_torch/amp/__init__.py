"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): paddle's
O1 ``auto_cast`` with its white and black op lists. ``decorate`` (O2) and
``GradScaler`` are not ported (``ROADMAP.md`` Queue 1 item 6)."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_cast, amp_guard,  # noqa: F401
                        auto_cast, current_amp_state)

__all__ = ["auto_cast", "amp_guard", "amp_cast", "current_amp_state",
           "WHITE_LIST", "BLACK_LIST"]
