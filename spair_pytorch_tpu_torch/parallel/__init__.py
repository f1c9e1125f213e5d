from spair_pytorch_tpu_torch.parallel.train_step import (  # noqa: F401
    make_eval_step,
)
