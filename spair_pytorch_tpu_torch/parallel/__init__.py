from spair_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from spair_pytorch_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    optimizer,
    train_step,
)
