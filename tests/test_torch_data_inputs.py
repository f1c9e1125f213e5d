"""The port's host data inputs against the JAX package's, on the CPU: the
native C++ generator's batches equal bit for bit (same source, same seed
per batch), HDF5 files written by either package read back equal in the
other, and train() takes steps from both sources."""

import json
import os

import numpy as np
import pytest
import torch

from spair_pytorch_tpu.data import DataConfig as JDataConfig
from spair_pytorch_tpu.data import ScatteredMNISTFile as JFile
from spair_pytorch_tpu.data import build_hdf5 as jbuild
from spair_pytorch_tpu.data.native import NativeScatteredDigits as JNative
from spair_pytorch_tpu_torch import train as ttrain
from spair_pytorch_tpu_torch.data import DataConfig, ScatteredMNISTFile
from spair_pytorch_tpu_torch.data import build_hdf5 as tbuild
from spair_pytorch_tpu_torch.data import native as tnative
from tests.test_model import tiny_config
from tests.test_torch_ops import tcfg

DIMS = dict(image_hw=(128, 128), patch_hw=(14, 14), min_objects=1,
            max_objects=6)


@pytest.mark.parametrize("seed", [0, 11])
def test_native_batches_equal_jax_bit_for_bit(seed):
    """Batch indices 0 and 1 of two seeds, at paper128's scene size."""
    want = JNative(JDataConfig(**DIMS), batch=8, seed=seed)
    got = tnative.NativeScatteredDigits(DataConfig(**DIMS), batch=8,
                                        seed=seed, device="cpu")
    for index in range(2):
        w, g = next(want), next(got)
        for a, b in zip(w, g):
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), a)
        assert got.index == index + 1


def test_native_library_builds_from_the_source_into_the_build_dir():
    path = tnative.build_native()
    assert path == tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "spair_pytorch_tpu_torch"
    assert tnative.SOURCE.name == "scattered_digits.cc"
    # named by the source's hash: another source would build elsewhere
    assert path.name.startswith("spair_native_") and path.suffix == ".so"


def test_native_channels_repeat_and_counts_bound():
    dcfg = DataConfig(image_hw=(48, 48), patch_hw=(10, 10), max_objects=3,
                      channels=3)
    img, bbox, count = next(tnative.NativeScatteredDigits(
        dcfg, batch=4, seed=5, device="cpu"))
    assert tuple(img.shape) == (4, 3, 48, 48)
    assert torch.equal(img[:, 0], img[:, 2])
    assert tuple(bbox.shape) == (4, 3, 4) and tuple(count.shape) == (4, 1)
    assert bool(((count >= 1) & (count <= 3)).all())


@pytest.mark.parametrize("kw", [dict(bank=np.zeros((3, 14, 14), "f")),
                                dict(dcfg=DataConfig(image_hw=(8, 8))),
                                dict(dcfg=DataConfig(min_objects=0))],
                         ids=["bank", "canvas", "objects"])
def test_native_refuses_sizes_the_generator_cannot_take(kw):
    dcfg = kw.pop("dcfg", DataConfig(patch_hw=(10, 10)))
    with pytest.raises(ValueError):
        tnative.NativeScatteredDigits(dcfg, batch=2, device="cpu", **kw)


def read_all(reader):
    return [np.concatenate(parts) for parts in
            zip(*reader.batches(5, drop_last=False))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_written_by_either_package_reads_back_equal(tmp_path, writer):
    pytest.importorskip("h5py")
    dims = dict(image_hw=(48, 48), patch_hw=(10, 10), max_objects=3)
    build = (tbuild.build(str(tmp_path / "p.hdf5"), 23, DataConfig(**dims),
                          seed=3, chunk=8, digits="font")
             if writer == "port" else
             jbuild.build(str(tmp_path / "j.hdf5"), 23, JDataConfig(**dims),
                          seed=3, chunk=8, digits="font"))
    ours, theirs = ScatteredMNISTFile(build), JFile(build)
    try:
        assert len(ours) == len(theirs) == 23
        for a, b in zip(read_all(ours), read_all(theirs)):
            np.testing.assert_array_equal(a, b)
        img, bbox, count = ours[7]
        assert img.shape == (1, 48, 48) and bbox.shape == (3, 4)
        assert 1 <= float(count[0]) <= 3
        assert sum(ours[i][0].sum() for i in range(10)) > 0
        assert len(list(ours.batches(5))) == 4  # drop_last
    finally:
        ours.close()


def test_both_packages_write_the_same_file(tmp_path):
    """Both build from the native generator with the same seed, so the
    files' datasets, dtypes and chunking agree."""
    h5py = pytest.importorskip("h5py")
    dims = dict(image_hw=(48, 48), patch_hw=(10, 10), max_objects=3)
    tbuild.main(["--out", str(tmp_path / "p.hdf5"), "--n", "20",
                 "--size", "48", "--patch", "10", "--max-objects", "3",
                 "--seed", "4", "--digits", "font"])
    jbuild.build(str(tmp_path / "j.hdf5"), 20, JDataConfig(**dims), seed=4,
                 digits="font")
    with h5py.File(tmp_path / "p.hdf5") as p, h5py.File(tmp_path / "j.hdf5") as j:
        for name in ("image", "bbox", "digit_count"):
            a, b = p["train/full"][name], j["train/full"][name]
            assert (a.shape, a.dtype, a.chunks) == (b.shape, b.dtype,
                                                    b.chunks)
            np.testing.assert_array_equal(a[()], b[()])


CFG = tcfg(tiny_config(batch_size=4, inference_mode="independent"))
RUN = dict(metrics_every=0, digits="font", verbose=False, device="cpu")


def metric_rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_from_hdf5(tmp_path):
    pytest.importorskip("h5py")
    path = tbuild.build(str(tmp_path / "d.hdf5"), 12,
                        ttrain.data_config(CFG), seed=1, chunk=4,
                        digits="font")
    state = ttrain.train(CFG, steps=2, logdir=str(tmp_path / "run"),
                         hdf5=path, checkpoint_every=0, **RUN)
    assert int(state.step) == 2
    rows = metric_rows(tmp_path / "run")
    assert [r["step"] for r in rows if "losses/total" in r] == [0, 1]
    assert all(np.isfinite(r["losses/total"]) for r in rows
               if "losses/total" in r)


def test_train_from_native_data(tmp_path):
    """Two steps with a checkpoint and a held-out evaluation from the same
    source; make_data's native source is the C++ generator of seed 0."""
    state = ttrain.train(CFG, steps=2, logdir=str(tmp_path / "run"),
                         data_source="native", checkpoint_every=2,
                         eval_every=2, eval_batches=1, **RUN)
    assert int(state.step) == 2
    rows = metric_rows(tmp_path / "run")
    assert any("eval/count_exact_accuracy" in r for r in rows)
    assert os.path.isfile(tmp_path / "run" / "checkpoints" / "2" /
                          "state.pt")
    data = ttrain.make_data(CFG, source="native", digits="font",
                            device="cpu")
    want = tnative.NativeScatteredDigits(ttrain.data_config(CFG), 4,
                                         bank=data.bank, seed=0,
                                         device="cpu")
    for a, b in zip(next(data), next(want)):
        assert torch.equal(a, b)


def test_make_data_refuses_an_unknown_source():
    with pytest.raises(ValueError):
        ttrain.make_data(CFG, source="disk", device="cpu")
