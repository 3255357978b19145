"""Architecture registry: maps ``--arch`` ids to configs.

The port registers all ten of the reference's architectures: ``dense``
(stablelm-3b, yi-6b, phi3-medium-14b, deepseek-67b), ``ssm``
(mamba2-1.3b), ``hybrid`` (zamba2-1.2b), ``moe`` (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b), ``vlm`` (qwen2-vl-72b) and ``encdec``
(seamless-m4t-large-v2).  An id in ``NOT_YET_PORTED`` (none now) raises
``NotImplementedError`` naming the ROADMAP step that ports it; any other
unknown id raises ``KeyError``.
"""
from __future__ import annotations

from repro_torch.config.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import (
    deepseek_67b,
    mamba2_1p3b,
    moonshot_v1_16b_a3b,
    phi3_medium_14b,
    qwen2_vl_72b,
    qwen3_moe_30b_a3b,
    seamless_m4t_large_v2,
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
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "qwen2-vl-72b": qwen2_vl_72b,
}

#: Architectures known but not ported, by id → (family, the ROADMAP
#: Queue 1 step that ports it).  Empty: every reference id is ported.
NOT_YET_PORTED: dict[str, tuple[str, str]] = {}

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


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell, as the reference rules:
    ``long_500k`` needs sub-quadratic attention (ssm, hybrid)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (family={cfg.family})")
    return True, ""


def iter_cells(include_skipped: bool = False):
    """Yield (arch_id, ModelConfig, ShapeConfig, applicable, reason)."""
    for arch_id, cfg in ARCHS.items():
        for shape in SHAPES.values():
            ok, why = cell_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch_id, cfg, shape, ok, why
