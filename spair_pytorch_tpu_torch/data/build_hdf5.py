"""Build a reference-schema scattered-digits HDF5 file (counterpart of
``spair_pytorch_tpu/data/build_hdf5.py``).

The reference trains from ``scattered_mnist_128x128_obj14x14.hdf5``, group
'train/full' with image/bbox/digit_count, a file that was never published.
This writes one with the JAX package's datasets, dtypes and chunking, from
the native C++ generator (``data/native.py``), so a file written by either
package reads back equal in the other, and ``train --hdf5`` and the
reference implementation can both train from it. Needs h5py and g++; a
missing one raises.

Usage:
    python -m spair_pytorch_tpu_torch.data.build_hdf5 \\
        --out scattered_mnist_128x128_obj14x14.hdf5 --n 60000
"""

from __future__ import annotations

import argparse

from spair_pytorch_tpu_torch.data.digits import digit_bank
from spair_pytorch_tpu_torch.data.native import NativeScatteredDigits
from spair_pytorch_tpu_torch.data.scattered_mnist import DataConfig


def build(out: str, n: int, dcfg: DataConfig, seed: int = 0,
          group: str = "train/full", chunk: int = 512,
          digits: str = "auto"):
    """Write ``n`` scenes from the native generator (batches of ``chunk``
    from ``seed``) to ``out``; returns ``out``."""
    import h5py

    bank = digit_bank(digits, dcfg.patch_hw)
    gen = NativeScatteredDigits(dcfg, batch=chunk, bank=bank, seed=seed,
                                device="cpu")
    ih, iw = dcfg.image_hw
    with h5py.File(out, "w") as f:
        g = f.create_group(group)
        d_img = g.create_dataset("image", (n, ih, iw), dtype="f4",
                                 chunks=(min(chunk, n), ih, iw))
        d_bbox = g.create_dataset("bbox", (n, dcfg.max_objects, 4),
                                  dtype="f4")
        d_cnt = g.create_dataset("digit_count", (n, 1), dtype="f4")
        written = 0
        while written < n:
            img, bbox, cnt = (t.numpy() for t in next(gen))
            take = min(chunk, n - written)
            d_img[written:written + take] = img[:take, 0]
            d_bbox[written:written + take] = bbox[:take]
            d_cnt[written:written + take] = cnt[:take]
            written += take
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=60000)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--patch", type=int, default=14)
    p.add_argument("--min-objects", type=int, default=1)
    p.add_argument("--max-objects", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--digits", default="auto",
                   choices=["auto", "mnist", "sklearn", "font"])
    args = p.parse_args(argv)
    dcfg = DataConfig(image_hw=(args.size, args.size),
                      patch_hw=(args.patch, args.patch),
                      min_objects=args.min_objects,
                      max_objects=args.max_objects)
    out = build(args.out, args.n, dcfg, seed=args.seed, digits=args.digits)
    print(f"wrote {args.n} scenes to {out}")


if __name__ == "__main__":
    main()
