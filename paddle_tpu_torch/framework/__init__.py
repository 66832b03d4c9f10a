"""Framework pieces of the port (counterpart of ``paddle_tpu/framework``):
the facade's Tensor, dtypes, places, autograd, RNG, flags and
save/load."""
from .dtype import (  # noqa: F401
    DType, convert_dtype, to_torch_dtype, set_default_dtype,
    get_default_dtype, default_dtype,
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128,
)
from .place import (  # noqa: F401
    Place, CPUPlace, TPUPlace, CUDAPlace, CUDAPinnedPlace, set_device,
    get_device, device_count, is_compiled_with_cuda, is_compiled_with_tpu,
)
from .tensor import Tensor, Parameter, to_tensor  # noqa: F401
from .tape import (no_grad, enable_grad, is_grad_enabled,  # noqa: F401
                   set_grad_enabled, backward, grad)
from .random import seed, get_rng_state, set_rng_state, rng_guard  # noqa: F401
from .flags import set_flags, get_flags, define_flag  # noqa: F401
