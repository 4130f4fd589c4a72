"""Assigned-architecture registry: the port's copy of ``repro.configs``.

``get_config(name)`` returns the exact published config; ``get_smoke(name)``
returns the reduced same-family variant used by CPU smoke tests. The port
holds the ``dense`` configs (llama3, phi4, nemotron, mistral) and the
``moe`` ones (qwen3-moe, granite-moe) as data; the other ids stay listed,
and asking for one raises ``NotImplementedError`` naming the ROADMAP.md
item that ports its family.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.api import require_family
from repro_torch.models.config import ModelConfig

# every id of the reference's zoo -> its family (the module holding its
# config is ported with the family)
FAMILIES: Dict[str, str] = {
    "qwen2_vl_72b": "vlm", "xlstm_1_3b": "ssm", "nemotron_4_15b": "dense",
    "llama3_8b": "dense", "phi4_mini_3_8b": "dense",
    "mistral_large_123b": "dense", "whisper_large_v3": "audio",
    "qwen3_moe_30b_a3b": "moe", "granite_moe_1b_a400m": "moe",
    "zamba2_2_7b": "hybrid",
}
ARCH_IDS: List[str] = list(FAMILIES)

# canonical dashed ids (CLI) -> module names
ALIASES: Dict[str, str] = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(ALIASES)}")
    require_family(FAMILIES[name])
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
