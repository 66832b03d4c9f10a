"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): paddle's
O1 ``auto_cast`` with its white and black op lists, and dynamic loss
scaling (``GradScaler``, ``AmpScaler``). ``decorate`` (O2) is not ported
(``ROADMAP.md`` Queue 1 item 6)."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, amp_cast, amp_guard,  # noqa: F401
                        auto_cast, current_amp_state)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "amp_cast", "current_amp_state",
           "WHITE_LIST", "BLACK_LIST", "GradScaler", "AmpScaler"]
