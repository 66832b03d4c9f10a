"""Optimizers (counterpart of ``paddle_tpu/optimizer``).

Only the learning-rate schedulers are ported (:mod:`.lr`); the eager
optimizers need the ``nn`` Layer tree (``ROADMAP.md`` Queue 1 item 6). The
GPT training step runs its own AdamW.
"""
from . import lr  # noqa: F401
