"""paddle.static.nn layer-building functions (counterpart of
``paddle_tpu/static/nn/common.py``): each call builds the matching
``nn`` Layer (fresh parameters per call site, as the reference's) and
applies it, which records into the current Program. The convolutions
build the ``nn`` conv layers; the transposes derive ``filter_size`` from
``output_size`` when it is not given, as the JAX functions do.

``py_func`` waits for the ``jit`` lowering (``ROADMAP.md`` Queue 1 item
10).
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...ops import manipulation as _manip

__all__ = ["fc", "embedding", "sparse_embedding", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose", "batch_norm", "layer_norm",
           "group_norm", "instance_norm", "data_norm", "prelu",
           "bilinear_tensor_product"]


def _apply_act(out, act):
    if not act:
        return out
    fn = getattr(F, act, None)
    if fn is None:
        raise ValueError(f"unknown activation {act!r} for static.nn layer")
    return fn(out)


def _derive_transpose_kernel(in_sizes, out_sizes, stride, padding, dilation):
    """``filter_size=None`` with ``output_size`` set (the reference's
    contract): ``k = ((out - (in - 1) * stride + 2 * pad) - 1) // dilation
    + 1`` per axis."""
    if isinstance(padding, str):
        raise ValueError(
            "deriving filter_size from output_size needs numeric padding; "
            f"got padding={padding!r} — pass filter_size explicitly")

    def norm(v, n):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n
    n = len(in_sizes)
    s, p, d = (norm(stride, n), norm(padding, n), norm(dilation, n))
    o = norm(out_sizes, n)
    return [((o[i] - (in_sizes[i] - 1) * s[i] + 2 * p[i]) - 1) // d[i] + 1
            for i in range(n)]


def _flatten_to_2d(x, num_flatten_dims):
    shape = [int(s) for s in x.shape]
    lead = 1
    for s in shape[:num_flatten_dims]:
        lead *= s
    rest = 1
    for s in shape[num_flatten_dims:]:
        rest *= s
    return _manip.reshape(x, [lead, rest]), shape[:num_flatten_dims]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Fully connected (reference common.py fc): the dims from
    ``num_flatten_dims`` on are flattened, one Linear per input (summed,
    one bias); the output keeps the leading dims: ``shape[:num_flatten_
    dims] + [size]``."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = None
    lead_shape = None
    for xi in xs:
        flat, lead = _flatten_to_2d(xi, num_flatten_dims)
        lead_shape = lead_shape or lead
        lin = nn.Linear(int(flat.shape[-1]), size, weight_attr=weight_attr,
                        bias_attr=bias_attr if out is None else False)
        y = lin(flat)
        out = y if out is None else out + y
    if len(lead_shape) != 1:
        out = _manip.reshape(out, lead_shape + [size])
    return _apply_act(out, activation)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    emb = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                       weight_attr=param_attr)
    return emb(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32"):
    """The reference's sparse_embedding targets the parameter server; in
    one program it is a dense embedding lookup."""
    return embedding(input, size, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def _conv(layer, input, num_filters, filter_size, stride, padding, dilation,
          groups, param_attr, bias_attr, act, data_format):
    c_in = int(input.shape[1 if data_format.startswith("NC") else -1])
    conv = layer(c_in, num_filters, filter_size, stride, padding,
                 dilation=dilation, groups=groups, weight_attr=param_attr,
                 bias_attr=bias_attr, data_format=data_format)
    return _apply_act(conv(input), act)


def _conv_transpose(layer, input, num_filters, output_size, filter_size,
                    stride, padding, dilation, groups, param_attr, bias_attr,
                    act, data_format):
    channel_first = data_format.startswith("NC")
    c_in = int(input.shape[1 if channel_first else -1])
    if filter_size is None:
        if output_size is None:
            raise ValueError(f"{layer.__name__} needs filter_size or "
                             f"output_size")
        spatial = [int(s) for s in (input.shape[2:] if channel_first
                                    else input.shape[1:-1])]
        filter_size = _derive_transpose_kernel(spatial, output_size, stride,
                                               padding, dilation)
    conv = layer(c_in, num_filters, filter_size, stride, padding,
                 dilation=dilation, groups=groups, weight_attr=param_attr,
                 bias_attr=bias_attr, data_format=data_format)
    return _apply_act(conv(input, output_size=output_size), act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    return _conv(nn.Conv2D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, param_attr, bias_attr, act, data_format)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(nn.Conv2DTranspose, input, num_filters,
                           output_size, filter_size, stride, padding,
                           dilation, groups, param_attr, bias_attr, act,
                           data_format)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    return _conv(nn.Conv3D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, param_attr, bias_attr, act, data_format)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(nn.Conv3DTranspose, input, num_filters,
                           output_size, filter_size, stride, padding,
                           dilation, groups, param_attr, bias_attr, act,
                           data_format)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, **kw):
    # channels-first layouts are NC*: NCHW, NCDHW, NCL
    c = int(input.shape[1 if data_layout.startswith("NC") else -1])
    kwargs = dict(momentum=momentum, epsilon=epsilon,
                  weight_attr=param_attr, bias_attr=bias_attr)
    if input.ndim == 5:
        bn = nn.BatchNorm3D(c, data_format=data_layout, **kwargs)
    elif input.ndim == 4:
        bn = nn.BatchNorm2D(c, data_format=data_layout, **kwargs)
    else:
        bn = nn.BatchNorm1D(c, data_format=data_layout, **kwargs)
    bn.training = not is_test
    return _apply_act(bn(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    ln = nn.LayerNorm(shape, epsilon=epsilon,
                      weight_attr=param_attr if scale else False,
                      bias_attr=bias_attr if shift else False)
    return _apply_act(ln(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    c = int(input.shape[1 if data_layout == "NCHW" else -1])
    gn = nn.GroupNorm(groups, c, epsilon=epsilon, weight_attr=param_attr,
                      bias_attr=bias_attr, data_format=data_layout)
    return _apply_act(gn(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    c = int(input.shape[1])
    cls = nn.InstanceNorm2D if input.ndim == 4 else nn.InstanceNorm1D
    return cls(c, epsilon=epsilon, weight_attr=param_attr,
               bias_attr=bias_attr)(input)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", **kw):
    """The reference's data_norm, as the JAX package maps it: batch norm
    semantics."""
    return batch_norm(input, act=act, epsilon=epsilon,
                      param_attr=param_attr, data_layout=data_layout)


class _ElementPReLU(nn.Layer):
    """Per-element alpha (reference prelu mode='element'): a weight shaped
    like one sample, broadcast over the batch dim."""

    def __init__(self, sample_shape, weight_attr):
        super().__init__()
        from ...nn import initializer as I
        self.weight = self.create_parameter(
            list(sample_shape), attr=weight_attr,
            default_initializer=I.Constant(0.25))

    def forward(self, x):
        pos = F.relu(x)
        return pos + self.weight * (x - pos)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    if mode == "element":
        return _ElementPReLU([int(s) for s in x.shape[1:]], param_attr)(x)
    num = 1 if mode == "all" else \
        int(x.shape[1 if data_format == "NCHW" else -1])
    return nn.PReLU(num_parameters=num, weight_attr=param_attr,
                    data_format=data_format)(x)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    layer = nn.Bilinear(int(x.shape[-1]), int(y.shape[-1]), size,
                        weight_attr=param_attr, bias_attr=bias_attr)
    return _apply_act(layer(x, y), act)
