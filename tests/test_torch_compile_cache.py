"""Where the port builds its kernels and the native generator
(``utils/compile_cache.py``), under the JAX package's
``SPAIR_COMPILE_CACHE`` contract: unset, the package's ``_build/``; a
path, that directory; 0/off/false/none/empty, a fresh directory for the
process. The native library is built with g++ on the CPU; the CUDA
libraries' paths are resolved without nvcc."""

import os
import subprocess
import sys

import pytest

from spair_pytorch_tpu_torch.data import native
from spair_pytorch_tpu_torch.ops.kernels import composite as K
from spair_pytorch_tpu_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_unset_builds_into_the_package_build_dir(monkeypatch):
    monkeypatch.delenv("SPAIR_COMPILE_CACHE", raising=False)
    got = compile_cache.build_dir()
    assert got == compile_cache.DEFAULT_DIR
    assert got.name == "_build"
    assert got.parent.name == "spair_pytorch_tpu_torch"
    assert native.library_path().parent == got
    assert all(K.library_path(name).parent == got for name in K.SOURCES)


def test_a_path_redirects_both_builds(monkeypatch, tmp_path):
    target = tmp_path / "cache"
    monkeypatch.setenv("SPAIR_COMPILE_CACHE", str(target))
    assert compile_cache.build_dir() == target
    assert all(K.library_path(name).parent == target for name in K.SOURCES)
    lib = native.build_native()
    assert lib.parent == target and lib.exists()
    assert native.build_native() == lib  # a second call reuses it


@pytest.mark.parametrize("value", ["0", "off", "False", "none", ""])
def test_off_builds_into_a_fresh_directory_per_process(monkeypatch, value):
    """Off: a temporary directory of this process, never the package's,
    removed when the process exits; another process gets another one."""
    monkeypatch.setenv("SPAIR_COMPILE_CACHE", value)
    here = compile_cache.build_dir()
    assert here != compile_cache.DEFAULT_DIR and here.is_dir()
    assert compile_cache.build_dir() == here  # one per process
    assert native.library_path().parent == here
    code = ("from spair_pytorch_tpu_torch.data import native\n"
            "lib = native.build_native()\n"
            "print(lib.parent)\n")
    env = dict(os.environ, SPAIR_COMPILE_CACHE=value)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    other = out.stdout.strip().splitlines()[-1]
    assert other != str(here) and other != str(compile_cache.DEFAULT_DIR)
    assert not os.path.exists(other)  # removed at the child's exit


def test_a_failed_build_still_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("SPAIR_COMPILE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_native()
