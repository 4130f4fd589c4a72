"""Attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. One launch
computes ``softmax(q kᵀ / sqrt(dh)) v`` for every (batch, head), causal or
not, with grouped-query heads read by index (query head ``h`` reads KV head
``h // (H // Hkv)``). bf16 inputs run on the tensor cores with fp32
accumulators; fp32 inputs run in fp32 FMAs. The plain version is
``repro_torch.kernels.ref.flash_attention``; ``repro_torch.kernels.ops``
picks between them by the device of the inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
_ENTRY = {torch.bfloat16: "bf16", torch.float32: "f32"}
launches = 0   # kernel launches since the last ops.reset_launch_counts()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """q:[B,H,S,dh], k/v:[B,Hkv,S,dh], one dtype (bf16 or fp32), contiguous
    on one CUDA device; H % Hkv == 0, dh in ``HEAD_DIMS``. Returns
    ``[B,H,S,dh]`` in q's dtype."""
    global launches
    dev = q.device
    dtypes = tuple(_ENTRY)
    _build.require(q, "q", dtypes, 4, dev)
    _build.require(k, "k", (q.dtype,), 4, dev)
    _build.require(v, "v", (q.dtype,), 4, dev)
    B, H, S, dh = q.shape
    hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, dh)
            or hkv < 1 or H % hkv or S < 1):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    lib, fn = _build.entry("flash_attention", 4, 6, _ENTRY[q.dtype])
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             hkv, S, dh, int(causal), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention", err)
    launches += 1
    return out
