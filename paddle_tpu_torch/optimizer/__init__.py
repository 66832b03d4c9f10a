"""Optimizers (counterpart of ``paddle_tpu/optimizer``): the learning-rate
schedulers (:mod:`.lr`) and ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``
(:mod:`.optimizer`). ``Lamb``, ``Adagrad``, ``RMSProp``, ``Adadelta`` and
``Adamax`` are not ported (``ROADMAP.md`` Queue 1 item 6). The GPT
training step runs its own AdamW."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adam, AdamW, L1Decay, L2Decay,  # noqa: F401
                        Momentum, Optimizer)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "L1Decay", "L2Decay"]
