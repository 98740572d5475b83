"""Model definitions of the port (counterpart of ``paddle_tpu/models``):
the Llama, DiT and MoE families."""

from . import dit  # noqa: F401
from . import llama  # noqa: F401
from . import moe_llama  # noqa: F401
from .dit import DiTConfig  # noqa: F401
from .llama import LlamaConfig  # noqa: F401
from .moe_llama import MoEConfig  # noqa: F401
