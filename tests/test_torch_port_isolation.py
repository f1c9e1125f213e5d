"""The port stands alone: no module of ``spair_pytorch_tpu_torch`` and
nothing in ``chip_smoke.py`` imports jax or the JAX package; the port's
config is its own copy and equals the JAX package's preset for preset; its
entry points default to the card."""

import ast
import dataclasses
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

import spair_pytorch_tpu_torch
from spair_pytorch_tpu import config as jconfig
from spair_pytorch_tpu_torch import bench
from spair_pytorch_tpu_torch import config as tconfig
from spair_pytorch_tpu_torch.models.latents import init_params
from spair_pytorch_tpu_torch.parallel.train_step import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        spair_pytorch_tpu_torch.__path__, "spair_pytorch_tpu_torch."))


def test_every_port_module_imports_without_jax_or_the_jax_package():
    """Every module, kernels included (nothing builds on import), in a
    fresh interpreter."""
    mods = port_modules()
    assert "spair_pytorch_tpu_torch.ops.kernels.composite_v3" in mods
    assert "spair_pytorch_tpu_torch.train" in mods
    assert "spair_pytorch_tpu_torch.ops.convcodec" in mods
    for m in ("models.refine", "utils.viz", "utils.compile_cache",
              "examples.quickstart", "bench"):
        assert f"spair_pytorch_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'spair_pytorch_tpu' or "
            "m.startswith('spair_pytorch_tpu.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "port sources"])
def test_no_source_names_jax_or_the_jax_package(path):
    """An ast walk over chip_smoke.py (whose port imports sit inside
    main) and over every source of the port, imports at any depth."""
    if path == "chip_smoke.py":
        files = [os.path.join(ROOT, path)]
    else:
        pkg = os.path.join(ROOT, "spair_pytorch_tpu_torch")
        files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
                 for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            names = set(imported_names(ast.parse(fh.read())))
        bad = sorted(n for n in names if n.split(".")[0] in
                     ("jax", "jaxlib", "spair_pytorch_tpu", "optax", "orbax"))
        assert not bad, (f, bad)


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_equal_the_jax_packages(preset):
    got = tconfig.PRESETS[preset]()
    want = jconfig.PRESETS[preset]()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got) is not type(want)  # a copy, not a re-export
    # and one package's JSON is the other's config
    assert tconfig.config_from_json(jconfig.config_to_json(want)) == got
    assert jconfig.config_from_json(tconfig.config_to_json(got)) == want


def test_module_level_names_equal_the_jax_packages():
    for name in ("TRAINING_WHEEL", "COUNT_PRIOR", "PRIORS",
                 "BACKBONE_TOPOLOGY", "FINE_BACKBONE_TOPOLOGY"):
        got, want = getattr(tconfig, name), getattr(jconfig, name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, name
    assert tconfig.free_box_priors() == jconfig.free_box_priors()


@pytest.mark.parametrize("fn", [init_params, create_train_state,
                                bench.run_check, bench.main])
def test_entry_points_default_to_the_card(fn):
    if fn is bench.main:  # a CLI: its --device flag
        assert bench.make_parser().get_default("device") == "cuda"
    else:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
