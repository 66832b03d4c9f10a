"""Distributed training (counterpart of ``paddle_tpu/distributed``): only
:class:`~paddle_tpu_torch.distributed.fleet.ParallelTrainStep` at one
device is ported (``ROADMAP.md`` Queue 1, 'Hybrid parallel')."""
from . import fleet  # noqa: F401
from .fleet import ParallelTrainStep  # noqa: F401

__all__ = ["fleet", "ParallelTrainStep"]
