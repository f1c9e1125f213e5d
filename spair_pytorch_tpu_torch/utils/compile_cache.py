"""Where the port's builds are cached (counterpart of
``spair_pytorch_tpu/utils/compile_cache.py``).

The JAX package caches XLA executables between runs. The port compiles no
graphs: what it builds are shared libraries, the compositor kernels with
``nvcc`` (``ops/kernels/composite.py``) and the native scene generator with
``g++`` (``data/native.py``), each named by the hash of its sources and
flags, so a directory of them is a cache that an edited source never hits
stale. ``build_dir`` resolves that directory under the JAX package's
``SPAIR_COMPILE_CACHE`` contract:

- unset: the package's ``_build/`` (git-ignored), so a checkout builds its
  kernels there at first use and reuses them after;
- a path: that directory (created on first build);
- ``0``, ``off``, ``false``, ``none`` or empty: a fresh temporary
  directory for this process, removed at its exit, so nothing is reused.

A build that fails raises, whichever directory it was for.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
from pathlib import Path

ENV = "SPAIR_COMPILE_CACHE"
DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"
_OFF_VALUES = ("0", "off", "false", "none", "")


@functools.lru_cache(maxsize=None)
def _fresh_dir(pid: int) -> Path:
    """A temporary build directory of process ``pid``, removed at exit."""
    path = tempfile.mkdtemp(prefix=f"spair_build_{pid}_")

    def remove():
        if os.getpid() == pid:  # not from a forked child's exit
            shutil.rmtree(path, ignore_errors=True)
    atexit.register(remove)
    return Path(path)


def build_dir() -> Path:
    """The directory builds go to now, from ``SPAIR_COMPILE_CACHE``."""
    env = os.environ.get(ENV)
    if env is None:
        return DEFAULT_DIR
    if env.strip().lower() in _OFF_VALUES:
        return _fresh_dir(os.getpid())
    return Path(env)
