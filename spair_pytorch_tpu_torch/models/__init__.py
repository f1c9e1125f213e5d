from spair_pytorch_tpu_torch.models.latents import (  # noqa: F401
    SpairModel,
    geometry,
    init_params,
    sample_noise,
)
from spair_pytorch_tpu_torch.models.spair import (  # noqa: F401
    forward,
    infer_latents,
    inference_schedule,
    loss_and_metrics,
)
