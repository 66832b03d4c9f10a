"""``paddle.static.nn`` (counterpart of ``paddle_tpu/static/nn``): the
layer-building functions of :mod:`.common`, the convolutions among them.
Not ported: ``py_func`` and the control flow of ``control_flow.py``
(``while_loop``, ``cond``, ``case``, ``switch_case``; item 10's ``jit``
lowering: a loop whose trip count depends on data cannot replay from one
CUDA graph as it is), and the ``sequence_*`` ops (item 5,
``ops/sequence.py``)."""
from .common import (  # noqa: F401
    fc, embedding, sparse_embedding, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose, batch_norm, layer_norm, group_norm,
    instance_norm, data_norm, prelu, bilinear_tensor_product,
)
from . import common  # noqa: F401

__all__ = ["common", "fc", "embedding", "sparse_embedding", "conv2d",
           "conv2d_transpose", "conv3d", "conv3d_transpose", "batch_norm",
           "layer_norm", "group_norm", "instance_norm", "data_norm", "prelu",
           "bilinear_tensor_product"]
