"""Assigned-architecture registry: the port's copy of ``repro.configs``.

``get_config(name)`` returns the exact published config; ``get_smoke(name)``
returns the reduced same-family variant used by CPU smoke tests. Every
module defines ``FULL`` and ``SMOKE`` ModelConfig constants, as the
reference's do; every family has a model in the port
(``repro_torch.models.api``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen2_vl_72b",
    "xlstm_1_3b",
    "nemotron_4_15b",
    "llama3_8b",
    "phi4_mini_3_8b",
    "mistral_large_123b",
    "whisper_large_v3",
    "qwen3_moe_30b_a3b",
    "granite_moe_1b_a400m",
    "zamba2_2_7b",
]

# canonical dashed ids (CLI) -> module names
ALIASES: Dict[str, str] = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}


def supports_shape(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k needs a sub-quadratic token path: the recurrent (ssm) and
    hybrid families, whose decode state does not grow with the history."""
    if shape_name != "long_500k":
        return True
    return cfg.family in ("ssm", "hybrid")
