from spair_pytorch_tpu_torch.data.scattered_mnist import (  # noqa: F401
    DataConfig,
    draw_scenes,
    generate_batch,
    glyph_bank,
    place_patches,
)
