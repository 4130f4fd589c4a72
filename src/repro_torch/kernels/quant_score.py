"""The SQ-int8 score matrix on the card: the wrapper of
``csrc/quant_score.cu``.

Replaces ``repro.kernels.quant_score.quant_score_pallas``. The query is
prescaled here (``q * scale``, the same tensor op as the plain version), the
kernel upcasts the int8 codes tile by tile and writes every row's score:
there is no live mask, the caller masks and takes the top-k. The plain
version is ``repro_torch.kernels.ref.quant_score``;
``repro_torch.kernels.ops`` picks between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last ops.reset_launch_counts()


def quant_score_cuda(q: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """q:[nq,d] fp32, codes:[N,d] int8, scale:[d] fp32, all on one CUDA
    device; d % 4 == 0. Returns the scores ``[nq, N]`` fp32."""
    global launches
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
    lib, fn = _build.entry("quant_score", 3, 3)
    qs = (q * scale[None, :]).contiguous()
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    err = fn(qs.data_ptr(), codes.data_ptr(), out.data_ptr(), nq, n, d,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "quant_score", err)
    launches += 1
    return out
