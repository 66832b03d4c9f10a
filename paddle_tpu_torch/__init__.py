"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module names and public names so each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing from ``paddle_tpu``.

Importing it has no global side effects: no device is touched, no kernel
is built (the CUDA kernels compile at their first launch, see
:mod:`paddle_tpu_torch.kernels._build`), and no RNG state is seeded.

Ported so far, GPT serving and training, ERNIE-MoE serving and
pretraining, paddle's tensor facade and ``paddle.nn`` over it, BERT built
from it, and ``paddle.static`` over the facade (``ROADMAP.md`` lists the
rest):

- :mod:`.framework` — ``Tensor``/``Parameter`` over ``torch.Tensor``,
  ``to_tensor``, dtypes, places (``set_device``), autograd on torch's
  (``backward``, ``grad``, ``no_grad``), ``seed``, the flags, and
  ``save``/``load``; :mod:`.autograd` — ``PyLayer``;
- :mod:`.ops` — the ``paddle.*`` ops and their Tensor methods, all at the
  top level (``import paddle_tpu_torch as paddle``);
- :mod:`.nn` — ``Layer``, the layers (convolutions and poolings among
  them), ``functional``, ``initializer`` and the clips over the facade;
  :mod:`.models.bert` — BERT built from them; :mod:`.vision` — the
  ``vision.models`` zoo (ResNet, VGG, MobileNets, ...) built from them;
- :mod:`.static` — ``Program``, ``Executor``, ``data``, ``program_guard``,
  ``gradients``, ``static.nn`` and program (de)serialization: the facade's
  ops record under ``enable_static()`` (also at the top level) and the
  Executor runs a program as one CUDA graph per feed signature on the card
  (eagerly on the CPU), with ``Optimizer.minimize`` and ``auto_cast``
  fixed at record time; :mod:`.jit` — ``InputSpec`` alone so far;

- :mod:`.models.gpt` — the GPT model family as ``nn.Module``s and the
  training step (one CUDA graph per batch shape on the card);
- :mod:`.models.ernie`, :mod:`.incubate.distributed.models.moe` — the
  ERNIE-MoE model, its gates and ``MoELayer``, in training and eval;
- :mod:`.optimizer` — ``SGD``, ``Momentum``, ``Adam``, ``AdamW`` and the
  learning-rate schedulers; :mod:`.nn.clip` — the gradient clips;
- :mod:`.amp` — paddle's O1 ``auto_cast``;
- :mod:`.kernels.flash_attention` — FlashAttention-2 forward and
  backward (CUDA);
- :mod:`.kernels.paged_attention` — paged-attention decode and ragged
  chunk prefill (CUDA);
- :mod:`.kernels.int8_matmul` — weight-only int8 dequant-matmul (CUDA);
- :mod:`.quantization.export` — int8 quantization of the stacked weights;
- :mod:`.serving` — ``PagePool``, ``PrefixCache``, ``ServingEngine`` and
  ``ContinuousBatchingScheduler``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`.device.resolve_device`); the facade runs on the current place,
the card unless ``set_device("cpu")``.
"""
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"

from .framework import (  # noqa: E402,F401
    Tensor, to_tensor, no_grad, enable_grad, is_grad_enabled,
    set_grad_enabled, grad, seed, get_rng_state, set_rng_state, set_flags,
    get_flags, set_default_dtype, get_default_dtype, set_device, get_device,
    device_count, is_compiled_with_cuda,
    CPUPlace, TPUPlace, CUDAPlace, CUDAPinnedPlace,
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128,
)
from .framework.tensor import Parameter  # noqa: E402,F401
from .framework.dtype import DType as dtype  # noqa: E402,F401
from .framework.dtype import bool_ as bool  # noqa: E402,F401
from .framework.io import save, load, CheckpointCorruptError  # noqa: E402,F401
from .ops import *  # noqa: E402,F401,F403  (the paddle.* op surface)
from . import ops  # noqa: E402,F401
from . import amp, nn, optimizer, vision  # noqa: E402,F401
from .nn.layer.layers import ParamAttr  # noqa: E402,F401
from . import jit, static  # noqa: E402,F401
from .static import enable_static, disable_static  # noqa: E402,F401
