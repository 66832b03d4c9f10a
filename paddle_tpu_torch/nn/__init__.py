"""``paddle.nn`` over the tensor facade (counterpart of ``paddle_tpu/nn``):
``Layer`` and ``ParamAttr``, the containers, the common, activation, norm,
loss, transformer, convolution and pooling layers, ``functional``,
``initializer`` and the gradient clips. The RNN and extra layers and
``nn.utils`` are not ported yet (``ROADMAP.md``, Queue 1).

The torch-level ``Linear``/``LayerNorm`` the GPT and ERNIE-MoE models are
built from live in :mod:`paddle_tpu_torch.nn._torch_layers`.
"""
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.common import (  # noqa: F401
    Identity, Linear, Dropout, Dropout2D, Dropout3D, AlphaDropout, Embedding,
    Flatten, Upsample, UpsamplingNearest2D, UpsamplingBilinear2D, Pad1D,
    Pad2D, Pad3D, ZeroPad2D, CosineSimilarity, Bilinear, PixelShuffle,
    PixelUnshuffle, ChannelShuffle, Unfold, Fold,
)
from .layer.activation import (  # noqa: F401
    ReLU, ReLU6, ELU, CELU, SELU, GELU, Sigmoid, LogSigmoid, Hardsigmoid,
    Hardswish, Hardtanh, Hardshrink, Softshrink, Tanhshrink, LeakyReLU,
    PReLU, RReLU, Silu, Swish, Mish, Softplus, Softsign, Tanh, Softmax,
    LogSoftmax, Maxout, ThresholdedReLU,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, SyncBatchNorm,
    LayerNorm, RMSNorm, GroupNorm, InstanceNorm1D, InstanceNorm2D,
    InstanceNorm3D, LocalResponseNorm, SpectralNorm,
)
from .layer.container import (  # noqa: F401
    Sequential, LayerList, LayerDict, ParameterList,
)
from .layer.loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, NLLLoss, BCELoss, BCEWithLogitsLoss,
    SmoothL1Loss, KLDivLoss, MarginRankingLoss, HingeEmbeddingLoss,
    CosineEmbeddingLoss, TripletMarginLoss, CTCLoss,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose,
)
from .layer.pooling import (  # noqa: F401
    AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
)
from .clip import (  # noqa: F401
    ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm, clip_grad_norm_,
    clip_by_norm,
)
from . import clip, functional, initializer, layer  # noqa: F401
from .layer import (activation as _activation, common as _common,
                    container as _container, conv as _conv, loss as _loss,
                    norm as _norm, pooling as _pooling,
                    transformer as _transformer)

__all__ = (["Layer", "ParamAttr", "clip", "functional", "initializer",
            "layer", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_by_norm"]
           + _common.__all__ + _activation.__all__ + _norm.__all__
           + _container.__all__ + _loss.__all__ + _transformer.__all__
           + _conv.__all__ + _pooling.__all__)
