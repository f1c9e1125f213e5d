from spair_pytorch_tpu_torch.data.scattered_mnist import (  # noqa: F401
    DataConfig,
    OnDeviceScatteredDigits,
    draw_scenes,
    generate_batch,
    glyph_bank,
    place_patches,
)
from spair_pytorch_tpu_torch.data.digits import (  # noqa: F401
    digit_bank,
    find_mnist_file,
    load_mnist_idx,
    mnist_bank,
    resize_bilinear,
    resolve_source,
    sklearn_digit_bank,
)
