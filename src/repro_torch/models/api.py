"""Uniform model API of the port: family -> the module that implements it,
and the counts the reference's ``repro.models.api`` gives (parameters,
bytes, model FLOPs).

The ``dense`` and ``moe`` families are ported, both by
``repro_torch.models.transformer`` (``Transformer``, ``init``; MoE blocks
through ``repro_torch.models.moe``). Asking for another family raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

FAMILY_MODULES = {"dense": transformer, "moe": transformer}

# families of the reference's zoo that the port does not run yet -> the
# item of ROADMAP.md queue 1 that ports them
NOT_PORTED = {
    "vlm": "queue 1 item 7, the rest (vlm: M-RoPE)",
    "audio": "queue 1 item 9 (whisper)",
    "ssm": "queue 1 item 9 (xlstm)",
    "hybrid": "queue 1 item 9 (zamba2, mamba2)",
}


def require_family(family: str) -> None:
    """Raise unless the port has a model for ``family``."""
    if family in FAMILY_MODULES:
        return
    if family in NOT_PORTED:
        raise NotImplementedError(f"model family {family!r} is not ported "
                                  f"yet: ROADMAP.md {NOT_PORTED[family]}")
    raise ValueError(f"unknown model family {family!r}")


def get_model(cfg: ModelConfig):
    require_family(cfg.family)
    return FAMILY_MODULES[cfg.family]


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_bytes(model: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def model_flops(cfg: ModelConfig, batch: int, seq: int, kind: str) -> float:
    """MODEL_FLOPS for one step of the given shape cell.

    train    : fwd + bwd = 3x the forward pass -> 6·N·D_tokens
    prefill  : forward only -> 2·N·D_tokens
    decode   : one token per sequence -> 2·N·B
    """
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    if kind == "decode":
        return 2.0 * n * batch
    raise ValueError(kind)
