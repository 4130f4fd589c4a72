"""Attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. One launch
computes ``softmax(q kᵀ / sqrt(dh)) v`` for every (batch, head), causal or
not, with grouped-query heads read by index (query head ``h`` reads KV head
``h // (H // Hkv)``), and with a sliding ``window > 0`` the keys
``j <= i - window`` of query ``i`` masked (tiles wholly outside every
row's window are not read). bf16 at dh 64 and 128 runs the Hopper kernel (TMA,
wgmma, sm_90 cards only), which reads strided q/k/v views as they are and
writes its output in q's memory layout; bf16 at dh 16, 32 and 256 runs
mma.sync and fp32 runs fp32 FMAs, both on contiguous copies. Any other
head dim up to 256 is zero-padded to the next of ``HEAD_DIMS`` (a copy of
q, k and v), the kernel told the true dh for its softmax scale, and the
output sliced back. The plain version is
``repro_torch.kernels.ref.flash_attention``; ``repro_torch.kernels.ops``
picks between them by the device of the inputs.

Training (``flash_attention_op``, a ``torch.library`` operation with its
autograd registered): the forward asks the kernel for each row's
log-sum-exp beside the output, and the backward is ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``:
D = rowsum(dO * o), then dK/dV per KV-head key tile over its group's query
heads, then dQ per q tile), on contiguous ``[B, heads, S, dh]`` copies of
q, k, v, o and dO padded as the forward pads them. Its plain version is
``ref.flash_attention_bwd``.
"""
from __future__ import annotations

import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' instantiated head dims
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
    if not 1 <= dh <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {dh} not in [1, {HEAD_DIMS[-1]}]")


def padded_head_dim(dh: int) -> int:
    """The least instantiated head dim at or above ``dh``."""
    return next(w for w in HEAD_DIMS if w >= dh)


_CALL = struct.Struct("29q")   # the C entry point's argument array


def wgmma_call(q, k, v, o, causal: bool, scale_dh: int,
               window: int = 0, lse=None) -> bytes:
    """The packed arguments of ``flash_attention_wgmma``: the four
    pointers, B, H, Hkv, S, dh, causal, then the element strides of q, k,
    v and o, four each (the C entry point checks them: unit stride in the
    last dim, 16-byte multiples elsewhere, 16-byte aligned bases), then
    the head dim of the softmax scale ``1/sqrt(scale_dh)``, the window (0:
    none) and the fp32 ``[B, H, S]`` log-sum-exp output (0: none)."""
    B, H, S, dh = q.shape
    return _CALL.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, H, k.shape[1], S, dh, int(causal), *q.stride(),
                      *k.stride(), *v.stride(), *o.stride(), scale_dh,
                      window, 0 if lse is None else lse.data_ptr())


@functools.lru_cache(maxsize=None)
def _card(index: int):
    """(compute capability, name) of CUDA device ``index``."""
    p = torch.cuda.get_device_properties(index)
    return (p.major, p.minor), p.name


def _flash_wgmma(q, k, v, causal: bool, scale_dh: int, window: int,
                 lse=None) -> torch.Tensor:
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
    err = fn(wgmma_call(q, k, v, out, causal, scale_dh, window, lse),
             torch._C._cuda_getCurrentRawStream(dev.index))
    if err == INVALID_VALUE:
        raise ValueError(
            f"flash_attention takes views with unit stride in the last dim, "
            f"16-byte multiples elsewhere and 16-byte aligned bases; got "
            f"strides {[t.stride() for t in (q, k, v)]}, bases "
            f"{[t.data_ptr() % 16 for t in (q, k, v)]} (mod 16)")
    _build.check(lib, "flash_attention", err)
    return out


def _lse_out(q: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int = 0,
                         with_lse: bool = False):
    """q:[B,H,S,dh], k/v:[B,Hkv,S,dh], one dtype (bf16 or fp32) on one CUDA
    device; H % Hkv == 0, 1 <= dh <= 256; ``window > 0`` masks the keys
    ``j <= i - window`` (0 or less: no window, as the reference reads
    it). bf16 at dh 64/128 takes views
    with unit stride in dh and other strides in 16-byte multiples (the
    output keeps q's layout); the other paths copy to contiguous. A dh
    outside ``HEAD_DIMS`` runs at ``padded_head_dim(dh)`` on zero-padded
    copies of q, k and v, with the softmax scale of the true dh, and
    returns a view of the true columns. Returns ``[B,H,S,dh]`` in q's
    dtype; with ``with_lse`` also each row's natural log-sum-exp of its
    scaled logits, fp32 ``[B,H,S]`` (what the backward reads)."""
    _check_shapes(q, k, v)
    window = max(int(window), 0)
    dh = q.shape[3]
    width = padded_head_dim(dh)
    if width != dh:
        pad = (0, width - dh)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    lse = _lse_out(q) if with_lse else None
    if q.dtype == torch.bfloat16 and width in WGMMA_HEAD_DIMS:
        out = _flash_wgmma(q, k, v, causal, dh, window, lse)
    else:
        dev = q.device
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _build.require(q, "q", tuple(_ENTRY), 4, dev)
        _build.require(k, "k", (q.dtype,), 4, dev)
        _build.require(v, "v", (q.dtype,), 4, dev)
        B, H, S = q.shape[:3]
        lib, fn = _build.entry("flash_attention", 5, 8, _ENTRY[q.dtype])
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, H, k.shape[1], S,
                 width, int(causal), dh, window,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "flash_attention", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("flash_attention")
    out = out if width == dh else out[..., :dh]
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal: bool,
                             window: int = 0):
    """The gradients ``(dq [B,H,S,dh], dk, dv [B,Hkv,S,dh])`` of attention
    from its inputs, output ``o``, the output's gradient ``dout`` and the
    forward's log-sum-exp ``lse`` (fp32 ``[B,H,S]``), one dtype (bf16 or
    fp32) on one CUDA device, by ``csrc/flash_attention_bwd.cu``: D =
    rowsum(dO * o), then dK/dV and dQ. The five tensors are copied to
    contiguous ``[B, heads, S, dh]`` (and zero-padded as the forward pads
    them: zero columns add nothing to the true columns' gradients); the
    gradients are contiguous, or views of the true columns."""
    _check_shapes(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    window = max(int(window), 0)
    dh = q.shape[3]
    width = padded_head_dim(dh)
    if width != dh:
        pad = (0, width - dh)
        q, k, v, o, dout = (torch.nn.functional.pad(t, pad)
                            for t in (q, k, v, o, dout))
    q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
    dev = q.device
    _build.require(q, "q", tuple(_ENTRY), 4, dev)
    for name, t in (("k", k), ("v", v), ("o", o), ("dout", dout)):
        _build.require(t, name, (q.dtype,), 4, dev)
    lse = lse.contiguous()
    _build.require(lse, "lse", (torch.float32,), 3, dev)
    B, H, S = q.shape[:3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(lse)   # the kernel's scratch: D
    lib, fn = _build.entry("flash_attention_bwd", 10, 8, _ENTRY[q.dtype])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dsum.data_ptr(), B, H, k.shape[1], S, width,
             int(causal), dh, window,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "flash_attention_bwd", err)
    from repro_torch.kernels.ops import count_launch
    count_launch("flash_attention_bwd")
    if width != dh:
        dq, dk, dv = dq[..., :dh], dk[..., :dh], dv[..., :dh]
    return dq, dk, dv


# -- the library operations: training under autograd, and meta tensors -----


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int,
                       with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_cuda`` as a library operation -> ``(out, lse)``,
    the lse ``[0]`` unless ``with_lse``. Its autograd is the backward
    kernel (``flash_attention_bwd_op``, which needs ``with_lse``); on
    ``meta`` tensors it gives the shapes (``roofline.op_cost`` registers
    its FLOP formula)."""
    if with_lse:
        return flash_attention_cuda(q, k, v, causal, window, with_lse=True)
    out = flash_attention_cuda(q, k, v, causal, window)
    return out, q.new_empty(0, dtype=torch.float32)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, with_lse):
    lse_shape = q.shape[:3] if with_lse else (0,)
    return (q.new_empty(q.shape),
            q.new_empty(lse_shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, dout: torch.Tensor,
                           lse: torch.Tensor, causal: bool, window: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``flash_attention_bwd_cuda`` as a library operation."""
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal,
                                          window)
    return dq, dk, dv


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, dout, lse, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, with_lse = inputs
    if not with_lse:
        raise ValueError("flash_attention_op differentiates only with_lse")
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.window = causal, window


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, dout, lse, ctx.causal,
                                        ctx.window)
    return dq, dk, dv, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)
