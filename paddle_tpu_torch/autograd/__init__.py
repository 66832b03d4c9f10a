"""``paddle.autograd`` of the facade (counterpart of
``paddle_tpu/autograd``)."""
from ..framework.tape import (backward, enable_grad, grad,  # noqa: F401
                              is_grad_enabled, no_grad, set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext, saved_tensors_hooks  # noqa: F401
