"""Configuration, shared with the JAX package rather than copied.

``spair_pytorch_tpu/config.py`` imports only ``dataclasses`` and ``typing``,
and ``spair_pytorch_tpu/__init__.py`` imports only that module, so reusing it
brings in no jax. A config therefore names the same model in both packages.
"""

from spair_pytorch_tpu.config import (  # noqa: F401
    PRESETS,
    Schedule,
    SpairConfig,
    paper_config,
    small_config,
)

__all__ = ["PRESETS", "Schedule", "SpairConfig", "paper_config",
           "small_config"]
