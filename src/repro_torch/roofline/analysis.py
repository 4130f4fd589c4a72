"""The card's peaks and the roofline of one model step on them: the port of
``repro.roofline.analysis``.

    compute term = the step's FLOPs        / the card's bf16 peak
    memory term  = the step's device bytes / the card's memory rate

``HW`` keeps the reference's fields (``peak_flops``, ``hbm_bw``,
``link_bw``) and adds the card's fp32 and int8 peaks; ``H100`` holds the
NVIDIA H100 SXM's (data sheet, dense rates, at its 700 W limit), the one
source of every bound the port prints (``chip_smoke.py`` and PERF.md).
``bound`` is the least time of one piece of work: the larger of its bytes
over the memory rate and its operations over their type's peak.

``roofline_report`` returns the reference's record for one (arch, shape)
cell, its FLOPs and bytes counted by ``roofline.op_cost`` on ``meta``
tensors (the counterpart of ``roofline.hlo_cost``, which parses XLA's HLO
text). On ``n_chips > 1`` the cost is one rank's in the step lowered on a
mesh (``launch.specs.lower_cell``): its local FLOPs and bytes, and the
link bytes of its collectives by kind (the functional collectives DTensor
issued, with the reference's ring factors), over ``link_bw`` the third
term:

    collective term = the step's link bytes a chip / the card's link rate

Fields that only XLA can fill hold ``None``:

* ``xla_flops_per_chip`` / ``xla_bytes_per_chip``: XLA's own
  ``cost_analysis()`` of a compiled artifact, which torch does not make;
* ``per_device_bytes``: XLA's ``memory_analysis()`` of the compiled step;
  the dry-run (``launch.dryrun``) fills its arguments and outputs from the
  local shard sizes. Its temporaries exist on the card only
  (``torch.cuda.max_memory_allocated`` after a real step).

A one-device step has no collective term: those fields are ``None``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.models import api
from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    peak_flops: float                  # bf16 tensor operations a second
    hbm_bw: float                      # device-memory bytes a second
    link_bw: float                     # bytes a second per link, each way
    fp32_flops: Optional[float] = None  # fp32 FMA operations a second
    int8_ops: Optional[float] = None    # int8 tensor operations a second


# NVIDIA H100 SXM (data sheet, dense, without sparsity, at 700 W): 3.35 TB/s
# HBM3; 989 TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 67
# TFLOP/s fp32 outside them; NVLink 450 GB/s each way.
H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
          fp32_flops=67e12, int8_ops=1979e12)


def bound(n_bytes: float, n_flop: float, peak: Optional[float] = None,
          hw: HW = H100) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time ``hw`` takes to
    move ``n_bytes`` (each input read once, each output written once) and
    do ``n_flop`` operations at ``peak`` a second (default: the bf16
    tensor peak)."""
    t_bytes = n_bytes / hw.hbm_bw
    t_ops = n_flop / (hw.peak_flops if peak is None else peak)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def feature_dims(cfg: ModelConfig) -> frozenset:
    """The config's feature widths, which ``op_cost`` never reads as a
    sequence dim: the reference's ``roofline_report`` passes the same, and
    the port adds RoPE's frequency width (half the head dim), whose
    ``[B, S, hd/2]`` tables would otherwise read as ``[S, S]``-shaped."""
    return frozenset(d for d in (
        cfg.d_model, 2 * cfg.d_model, cfg.d_ff, cfg.n_heads *
        cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim,
        cfg.resolved_head_dim, cfg.resolved_head_dim // 2, cfg.vocab_size,
        cfg.encoder_seq, (cfg.moe.expert_d_ff if cfg.moe else 0)) if d)


def roofline_report(cfg: ModelConfig, shape: ShapeConfig, n_chips: int = 1,
                    hw: HW = H100, cost=None) -> Dict[str, object]:
    """The roofline record of one (arch x shape) cell, with the
    reference's keys, per chip. ``cost`` is an ``op_cost.OpCost`` of the
    step; on one card ``op_cost.step_cost(cfg, shape)`` counts it on
    ``meta`` tensors by default (no card, no allocation); on ``n_chips >
    1`` it must be the lowered sharded step's (``launch.specs.lower_cell``,
    ``launch.dryrun.run_cell``), whose collectives give the third term.
    ``memory_flash_s`` drops the traffic of ``[S, S]``-shaped tensors
    (``sq_bytes``), which the port's attention kernels keep on chip."""
    if cost is None:
        if n_chips != 1:
            raise ValueError("a sharded cell's cost comes from its lowered "
                             "step: launch.dryrun.run_cell")
        from repro_torch.roofline import op_cost
        cost = op_cost.step_cost(cfg, shape)
    compute_s = cost.flops / hw.peak_flops
    memory_s = cost.hbm_bytes / hw.hbm_bw
    memory_flash_s = max(cost.hbm_bytes - cost.sq_bytes, 0.0) / hw.hbm_bw
    terms = {"compute": compute_s, "memory": memory_s}
    sharded = cost.collectives is not None
    coll_bytes = cost.link_bytes if sharded else None
    collective_s = coll_bytes / hw.link_bw if sharded else None
    if sharded:
        terms["collective"] = collective_s
    bottleneck = max(terms, key=terms.get)
    model_fl = api.model_flops(cfg, shape.global_batch, shape.seq_len,
                               shape.kind)
    useful = model_fl / (cost.flops * n_chips) if cost.flops else 0.0
    step_s = max(terms.values())
    # achievable fraction of the compute roofline given the dominant term
    mfu_bound = ((model_fl / n_chips / hw.peak_flops) / step_s if step_s
                 else 0.0)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "n_chips": n_chips,
        "flops_per_chip": cost.flops,
        "bytes_per_chip": cost.hbm_bytes,
        "collective_bytes_per_chip": coll_bytes,
        "collectives": dict(cost.collectives) if sharded else None,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_flash_s": memory_flash_s,
        "sq_bytes_per_chip": cost.sq_bytes,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops": model_fl,
        "useful_flop_ratio": useful,
        "roofline_fraction": mfu_bound,
        "xla_flops_per_chip": None,          # XLA's cost_analysis only
        "xla_bytes_per_chip": None,
        "per_device_bytes": None,            # max_memory_allocated, card only
    }
