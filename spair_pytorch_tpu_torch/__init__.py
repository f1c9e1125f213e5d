"""spair_pytorch_tpu_torch: the PyTorch/CUDA port of spair_pytorch_tpu.

The JAX package beside it is the reference: every public function here keeps
that package's layouts (images NCHW, latent grids (B, gh, gw, D), aux grids
NCHW) so the two can be compared on the same inputs. Parameters live in
``nn.Module``s named after the reference ``state_dict`` keys; every draw takes
an explicit ``torch.Generator``; every tensor factory names its device.

Importing the package pulls in only the shared config (no jax); the model,
serving and kernel modules are imported by name.
"""

from spair_pytorch_tpu_torch import config as config  # noqa: F401
from spair_pytorch_tpu_torch.config import (  # noqa: F401
    PRESETS,
    Schedule,
    SpairConfig,
)

__version__ = "0.1.0"
