from dpft_tpu_torch.models.layers.attention import MultiheadAttention  # noqa: F401
from dpft_tpu_torch.models.layers.common import (  # noqa: F401
    get_activation, get_compute_dtype, init_parameters,
)
from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn  # noqa: F401
from dpft_tpu_torch.models.layers.unary import Unary1d  # noqa: F401
