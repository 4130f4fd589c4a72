"""Uniform model API of the port: family -> the module that implements it,
and the counts the reference's ``repro.models.api`` gives (parameters,
bytes, model FLOPs).

Every family of the reference's zoo is ported: ``dense``, ``moe`` and
``vlm`` by ``repro_torch.models.transformer`` (MoE blocks through
``models.moe``, M-RoPE and the embeddings input for the vlm backbone),
``audio`` by ``models.whisper``, ``ssm`` by ``models.xlstm`` and
``hybrid`` by ``models.zamba2`` (with ``models.mamba2``). Each module has
``Model`` (an ``nn.Module`` whose tensors ``init`` fills; on ``meta`` its
shapes alone), ``init(cfg, seed, device)`` and ``loss_fn(model, batch,
aux_weight)`` (the training loss; ``loss_fn`` here picks the family's).
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import transformer, whisper, xlstm, zamba2
from repro_torch.models.config import ModelConfig

FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "audio": whisper,
    "ssm": xlstm,
    "hybrid": zamba2,
}


def get_model(cfg: ModelConfig):
    try:
        return FAMILY_MODULES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None


def build(cfg: ModelConfig, device=None) -> nn.Module:
    """The family's model for ``cfg`` with uninitialised tensors on
    ``device`` (``None`` is the card; ``meta`` allocates nothing)."""
    return get_model(cfg).Model(cfg, device=device)


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """The family's serving cache for ``batch`` rows of ``max_len`` on
    ``meta``: the reference's ``init_cache_shape``, leaf for leaf."""
    return get_model(cfg).init_cache_shape(cfg, batch, max_len)


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


def loss_fn(model: nn.Module, batch, moe_impl: str = "sort"):
    """The family's training loss of ``batch`` at its default auxiliary
    weight (0.01 for the transformer families' MoE load balancing, 0
    elsewhere), as the reference's ``make_train_step`` takes it."""
    mod = get_model(model.cfg)
    if mod is transformer:
        return mod.loss_fn(model, batch, moe_impl=moe_impl)
    return mod.loss_fn(model, batch)
