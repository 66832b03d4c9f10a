"""paddle_tpu_torch.static: the static-graph user API (counterpart of
``paddle_tpu/static``).

A Program is a recorded lazy op DAG, built by the op dispatch the dygraph
mode uses (:func:`paddle_tpu_torch.framework.tape.apply` records under
:func:`enable_static`; shapes come from running each op on ``meta``
tensors). ``Executor.run`` closes the DAG into one step function of the
feeds per feed signature; ``Optimizer.minimize`` on a lazy loss makes that
step take ``torch.autograd.grad`` and run the optimizer's update. On the
card the step is captured as one CUDA graph per feed signature and
replayed; on the CPU it runs eagerly. ``auto_cast`` is fixed at record
time, so a program built under it runs in low precision wherever it is
run.

Not ported: ``save_inference_model``/``load_inference_model`` (they raise;
the StableHLO export's counterpart goes with ``jit/save_load.py``),
``py_func`` and the control flow (``while_loop``, ``cond``), which wait
for the ``jit`` lowering (``ROADMAP.md`` Queue 1 item 10), and the
``static.nn`` convolutions (item 6.1).
"""
from ..nn.functional import *  # noqa: F401,F403  (the static.nn shims)
from ..nn import functional as _functional
from .program import (  # noqa: F401
    Program, program_guard, default_main_program, default_startup_program,
    enable_static, disable_static, in_static_mode, data, static_build,
    name_scope,
)
from .executor import Executor, global_scope  # noqa: F401
from .io import (save, load, save_inference_model,  # noqa: F401
                 load_inference_model)
from .serde import (  # noqa: F401
    save_program, load_program, serialize_program, deserialize_program,
)
from ..jit.save_load import InputSpec  # noqa: F401
from . import nn  # noqa: F401
from .. import amp  # noqa: F401  (paddle.static.amp)
from .parity import (  # noqa: F401
    Variable, BuildStrategy, ExecutionStrategy, CompiledProgram,
    ParallelExecutor, IpuStrategy, IpuCompiledProgram, ipu_shard_guard,
    set_ipu_shard, ExponentialMovingAverage, Print, WeightNormParamAttr,
    accuracy, auc, append_backward, gradients, cpu_places, cuda_places,
    npu_places, xpu_places, mlu_places, create_global_var,
    create_parameter, ctr_metric_bundle, device_guard, exponential_decay,
    load_from_file, save_to_file, load_program_state, set_program_state,
    normalize_program, scope_guard, serialize_persistables,
    deserialize_persistables,
)
from . import executor, io, parity, program, serde  # noqa: F401

__all__ = sorted(set(_functional.__all__) | {
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "enable_static", "disable_static",
    "in_static_mode", "data", "static_build", "name_scope", "Executor",
    "global_scope", "save", "load", "save_program", "load_program",
    "serialize_program", "deserialize_program", "InputSpec", "nn", "amp",
    "executor", "io", "parity", "program", "serde",
    *parity.__all__,
})
