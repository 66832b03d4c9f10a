"""Fleet (counterpart of ``paddle_tpu/distributed/fleet``): what is ported
is :class:`ParallelTrainStep` at one device. The mesh, the collectives,
the pipeline schedules, ZeRO and the rest of fleet are not
(``ROADMAP.md`` Queue 1, 'Hybrid parallel')."""
from .train_step import ParallelTrainStep  # noqa: F401

__all__ = ["ParallelTrainStep"]
