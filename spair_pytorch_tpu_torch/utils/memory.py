"""Device-memory observability (counterpart of ``spair_pytorch_tpu/utils/
memory.py``): the caching allocator's statistics per CUDA device, and the
largest live CUDA tensors."""

from __future__ import annotations

import gc

import torch


def device_memory_stats():
    """{'cuda:<i>': ``torch.cuda.memory_stats(i)``} for every visible CUDA
    device (bytes in use and their peak since the last
    ``torch.cuda.reset_peak_memory_stats``: ``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ...); empty without a card."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def live_array_report(top: int = 10) -> str:
    """The ``top`` largest live CUDA tensors (by storage, views counted
    once) and their total."""
    storages = {}
    for obj in gc.get_objects():
        # type(), not isinstance: no attribute lookups on arbitrary objects
        if issubclass(type(obj), torch.Tensor) and obj.is_cuda:
            st = obj.untyped_storage()
            storages.setdefault(st.data_ptr(), (st.nbytes(), obj))
    ranked = sorted(storages.values(), key=lambda s: -s[0])
    lines = [f"{n / 1e6:10.2f} MB  {tuple(t.shape)} {t.dtype}"
             for n, t in ranked[:top]]
    total = sum(n for n, _ in ranked)
    lines.append(f"total live: {total / 1e6:.1f} MB across {len(ranked)} "
                 "tensors")
    return "\n".join(lines)
