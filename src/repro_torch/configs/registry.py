"""Architecture registry: maps ``--arch`` ids to configs.

The port registers the architectures whose family it runs: ``dense``
(stablelm-3b, yi-6b, phi3-medium-14b, deepseek-67b), ``ssm``
(mamba2-1.3b), ``hybrid`` (zamba2-1.2b) and ``moe`` (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b).  The reference's other ids are known here and
raise ``NotImplementedError`` ("not yet ported") with the ROADMAP step
that brings their family; any other id raises ``KeyError``.
"""
from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.configs import (
    deepseek_67b,
    mamba2_1p3b,
    moonshot_v1_16b_a3b,
    phi3_medium_14b,
    qwen3_moe_30b_a3b,
    stablelm_3b,
    yi_6b,
    zamba2_1p2b,
)

_MODULES = {
    "zamba2-1.2b": zamba2_1p2b,
    "mamba2-1.3b": mamba2_1p3b,
    "phi3-medium-14b": phi3_medium_14b,
    "yi-6b": yi_6b,
    "deepseek-67b": deepseek_67b,
    "stablelm-3b": stablelm_3b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
}

#: The reference's other architectures, by id → (family, the ROADMAP
#: Queue 1 step that ports it).
NOT_YET_PORTED = {
    "seamless-m4t-large-v2": ("encdec", "step 5b.5 (the encdec family)"),
    "qwen2-vl-72b": ("vlm", "step 5b.4 (the vlm family, M-RoPE)"),
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in NOT_YET_PORTED:
        family, step = NOT_YET_PORTED[arch]
        raise NotImplementedError(
            f"arch {arch!r} (family {family!r}) is not yet ported: ROADMAP "
            f"Queue 1 {step}")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return _module(arch).reduced()
