"""``paddle.nn.functional`` over the tensor facade (counterpart of
``paddle_tpu/nn/functional``): activations, common functionals (linear,
dropout, embedding, interpolate, ...), norms, losses, attention, the
convolutions and the poolings. The extras are not ported yet
(``ROADMAP.md``, Queue 1)."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from . import activation, attention, common, conv, loss, norm, pooling

__all__ = (activation.__all__ + common.__all__ + norm.__all__ + loss.__all__
           + attention.__all__ + conv.__all__ + pooling.__all__)
