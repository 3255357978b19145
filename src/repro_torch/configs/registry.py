"""Architecture registry: maps ``--arch`` ids to configs.

The port registers the architectures whose family it runs.  The
reference's other ids are known here and raise ``NotImplementedError``
("not yet ported") with the ROADMAP step that brings their family; any
other id raises ``KeyError``.
"""
from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.configs import mamba2_1p3b, stablelm_3b, yi_6b

_MODULES = {
    "mamba2-1.3b": mamba2_1p3b,
    "yi-6b": yi_6b,
    "stablelm-3b": stablelm_3b,
}

#: The reference's other architectures, by id → family.
NOT_YET_PORTED = {
    "zamba2-1.2b": "hybrid",
    "phi3-medium-14b": "dense",
    "deepseek-67b": "dense",
    "moonshot-v1-16b-a3b": "moe",
    "qwen3-moe-30b-a3b": "moe",
    "seamless-m4t-large-v2": "encdec",
    "qwen2-vl-72b": "vlm",
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} (family {NOT_YET_PORTED[arch]!r}) is not yet "
            "ported: ROADMAP Queue 1 step 5b (the other LM families)")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return _module(arch).reduced()
