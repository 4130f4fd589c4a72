"""Attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. One launch
computes ``softmax(q kᵀ / sqrt(dh)) v`` for every (batch, head), causal or
not, with grouped-query heads read by index (query head ``h`` reads KV head
``h // (H // Hkv)``). bf16 at dh 64 and 128 runs the Hopper kernel (TMA,
wgmma, sm_90 cards only), which reads strided q/k/v views as they are and
writes its output in q's memory layout; bf16 at dh 16 and 32 runs mma.sync
and fp32 runs fp32 FMAs, both on contiguous copies. The plain version is
``repro_torch.kernels.ref.flash_attention``; ``repro_torch.kernels.ops``
picks between them by the device of the inputs.
"""
from __future__ import annotations

import functools
import struct

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)   # bf16 on the Hopper kernel
_ENTRY = {torch.bfloat16: "bf16", torch.float32: "f32"}
INVALID_VALUE = 1   # cudaErrorInvalidValue: the entry point refused its inputs


def _check_shapes(q, k, v) -> None:
    B, H, S, dh = q.shape
    hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, dh)
            or hkv < 1 or H % hkv or S < 1):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")


_CALL = struct.Struct("26q")   # the C entry point's argument array


def wgmma_call(q, k, v, o, causal: bool) -> bytes:
    """The packed arguments of ``flash_attention_wgmma``: the four
    pointers, B, H, Hkv, S, dh, causal, then the element strides of q, k,
    v and o, four each (the C entry point checks them: unit stride in the
    last dim, 16-byte multiples elsewhere, 16-byte aligned bases)."""
    B, H, S, dh = q.shape
    return _CALL.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, H, k.shape[1], S, dh, int(causal), *q.stride(),
                      *k.stride(), *v.stride(), *o.stride())


@functools.lru_cache(maxsize=None)
def _card(index: int):
    """(compute capability, name) of CUDA device ``index``."""
    p = torch.cuda.get_device_properties(index)
    return (p.major, p.minor), p.name


def _flash_wgmma(q, k, v, causal: bool) -> torch.Tensor:
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"q must be on a CUDA device, got {dev}")
    if (k.device != dev or v.device != dev or q.dtype != torch.bfloat16
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"q, k, v must be bf16 on {dev}, got "
                         f"{[(t.dtype, str(t.device)) for t in (q, k, v)]}")
    cap, card = _card(dev.index)
    if cap != (9, 0):
        raise RuntimeError(f"flash_attention: bf16 at dh {WGMMA_HEAD_DIMS} "
                           f"runs on wgmma, which needs an sm_90 card; "
                           f"{card} has compute capability {cap}")
    out = torch.empty_like(q)   # q's layout where q is dense, else contiguous
    lib, fn = _build.entry("flash_attention", 1, 0, "wgmma")
    # the current stream's raw handle (no Stream object: a few microseconds
    # a call, which the encoders' small grids would pay)
    err = fn(wgmma_call(q, k, v, out, causal),
             torch._C._cuda_getCurrentRawStream(dev.index))
    if err == INVALID_VALUE:
        raise ValueError(
            f"flash_attention takes views with unit stride in the last dim, "
            f"16-byte multiples elsewhere and 16-byte aligned bases; got "
            f"strides {[t.stride() for t in (q, k, v)]}, bases "
            f"{[t.data_ptr() % 16 for t in (q, k, v)]} (mod 16)")
    _build.check(lib, "flash_attention", err)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """q:[B,H,S,dh], k/v:[B,Hkv,S,dh], one dtype (bf16 or fp32) on one CUDA
    device; H % Hkv == 0, dh in ``HEAD_DIMS``. bf16 at dh 64/128 takes
    views with unit stride in dh and other strides in 16-byte multiples
    (the output keeps q's layout); the other paths copy to contiguous.
    Returns ``[B,H,S,dh]`` in q's dtype."""
    _check_shapes(q, k, v)
    if q.dtype == torch.bfloat16 and q.shape[3] in WGMMA_HEAD_DIMS:
        out = _flash_wgmma(q, k, v, causal)
    else:
        dev = q.device
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _build.require(q, "q", tuple(_ENTRY), 4, dev)
        _build.require(k, "k", (q.dtype,), 4, dev)
        _build.require(v, "v", (q.dtype,), 4, dev)
        B, H, S, dh = q.shape
        lib, fn = _build.entry("flash_attention", 4, 6, _ENTRY[q.dtype])
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 H, k.shape[1], S, dh, int(causal),
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "flash_attention", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("flash_attention")
    return out
