"""Per-rank scene generation for data-parallel training (counterpart of
``spair_pytorch_tpu/data/sharded.py``).

Each rank generates only its own slice of the global batch, and what a
rank trains on does not depend on the world size: every rank draws the
whole global batch's layout (``draw_scenes``: B x M small integers, from a
generator in the same state on every rank) and places patches only for its
own ``[start, stop)`` slice. The global batch assembled from the ranks'
slices is the batch one process generates from the same generator state,
exactly, for any world size.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spair_pytorch_tpu_torch.data.scattered_mnist import (DataConfig,
                                                          draw_scenes,
                                                          place_patches)

__all__ = ["host_slice", "generate_host_local"]


def host_slice(global_batch: int, num_processes: int,
               process_index: int) -> Tuple[int, int]:
    """[start, stop) of the global batch owned by ``process_index``:
    contiguous equal slices in rank order. The global batch must divide
    evenly."""
    if global_batch % num_processes:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{num_processes} processes")
    per = global_batch // num_processes
    return process_index * per, (process_index + 1) * per


def generate_host_local(generator: torch.Generator, bank, dcfg: DataConfig,
                        global_batch: int, num_processes: int,
                        process_index: int):
    """This rank's slice (image, bbox, count) of the global batch that
    ``generate_batch(generator, bank, global_batch, dcfg)`` would make;
    advances ``generator`` as that call does."""
    start, stop = host_slice(global_batch, num_processes, process_index)
    picks, oys, oxs, count = draw_scenes(generator, bank.shape[0],
                                         global_batch, dcfg)
    return place_patches(bank, picks[start:stop], oys[start:stop],
                         oxs[start:stop], count[start:stop], dcfg)
