"""The SQ-int8 score matrix on the card: the wrapper of
``csrc/quant_score.cu``.

Replaces ``repro.kernels.quant_score.quant_score_pallas``. The query is
prescaled here (``q * scale``, the same tensor op as the plain version) and
split into int8 limbs (``fused_retrieve.sq8_limbs``); the kernel scores
every code row on the int8 tensor cores, bit for bit
``fused_retrieve.sq8_limb_scores``, and writes the whole ``[nq, N]`` matrix:
there is no live mask, the caller masks and takes the top-k. The plain
version is ``repro_torch.kernels.ref.quant_score``;
``repro_torch.kernels.ops`` picks between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_retrieve import sq8_limbs



def quant_score_cuda(q: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """q:[nq,d] fp32, codes:[N,d] int8, scale:[d] fp32, all on one CUDA
    device; d % 4 == 0. Returns the scores ``[nq, N]`` fp32:
    ``sq8_limb_scores``, within 1e-5 of ``ref.quant_score``."""
    dev = q.device
    _build.require(q, "q", (torch.float32,), 2, dev)
    _build.require(codes, "codes", (torch.int8,), 2, dev)
    _build.require(scale, "scale", (torch.float32,), 1, dev)
    nq, d = q.shape
    n = codes.shape[0]
    if codes.shape[1] != d or scale.shape[0] != d or n < 1 or nq < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} codes "
                         f"{tuple(codes.shape)} scale {tuple(scale.shape)}")
    if d % 4:
        raise ValueError(f"need d % 4 == 0, got d={d}")
    lib, fn = _build.entry("quant_score", 4, 4, "s8")
    blocks = min(-(-n // _build.tile_rows("quant_score")),
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    limbs, e = sq8_limbs(q * scale[None, :])
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    err = fn(limbs.data_ptr(), e.data_ptr(), codes.data_ptr(),
             out.data_ptr(), nq, n, d, blocks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "quant_score", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("quant_score")
    return out
