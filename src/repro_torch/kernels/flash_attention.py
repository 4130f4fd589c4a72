"""Attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. One launch
computes ``softmax(q kᵀ / sqrt(dh)) v`` for every (batch, head), causal or
not, with grouped-query heads read by index (query head ``h`` reads KV head
``h // (H // Hkv)``), and with a sliding ``window > 0`` the keys
``j <= i - window`` of query ``i`` masked (tiles wholly outside every
row's window are not read), and with ``softcap > 0`` the scaled logits
capped to ``softcap * tanh(s / softcap)`` before the mask. bf16 at dh 64
and 128 runs the Hopper kernel (TMA, wgmma, sm_90 cards only), which reads
strided q/k/v views as they are and writes its output in q's memory
layout; bf16 at dh 16, 32 and 256 runs mma.sync and fp32 runs fp32 FMAs,
both on contiguous copies. Any other
head dim up to 256 is zero-padded to the next of ``HEAD_DIMS`` (a copy of
q, k and v), the kernel told the true dh for its softmax scale, and the
output sliced back. The plain version is
``repro_torch.kernels.ref.flash_attention``; ``repro_torch.kernels.ops``
picks between them by the device of the inputs.

Training (``flash_attention_op``, a ``torch.library`` operation with its
autograd registered): the forward asks the kernel for each row's
log-sum-exp beside the output, and the backward is
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``). bf16 at dh
64 and 128 runs its Hopper design (one pass over the keys, dQ summed in a
fixed order) on the callers' strided views, with the gradients in q's, k's
and v's layouts; the other paths run three passes (D, dK/dV, dQ) on
contiguous copies. Padded head dims as the forward pads them. Its plain
version is ``ref.flash_attention_bwd``.
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


_CALL = struct.Struct("29qd")   # the C entry point's argument array
_BWD_CALL = struct.Struct("52qd")   # the backward's
BQ = 64   # the Hopper backward's q tile: its scratch rows are padded to it


def wgmma_call(q, k, v, o, causal: bool, scale_dh: int,
               window: int = 0, lse=None, softcap: float = 0.0) -> bytes:
    """The packed arguments of ``flash_attention_wgmma``: the four
    pointers, B, H, Hkv, S, dh, causal, then the element strides of q, k,
    v and o, four each (the C entry point checks them: unit stride in the
    last dim, 16-byte multiples elsewhere, 16-byte aligned bases), then
    the head dim of the softmax scale ``1/sqrt(scale_dh)``, the window (0:
    none), the fp32 ``[B, H, S]`` log-sum-exp output (0: none) and the
    soft cap (0: none)."""
    B, H, S, dh = q.shape
    return _CALL.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, H, k.shape[1], S, dh, int(causal), *q.stride(),
                      *k.stride(), *v.stride(), *o.stride(), scale_dh,
                      window, 0 if lse is None else lse.data_ptr(),
                      float(softcap))


def bwd_wgmma_call(q, k, v, o, dout, lse, grads, scratch, causal: bool,
                   scale_dh: int, window: int, softcap: float) -> bytes:
    """The packed arguments of ``flash_attention_bwd_wgmma``: the pointers
    of q, k, v, o, dout, lse, the gradients (dq, dk, dv) and the scratch
    (the fp32 dQ accumulator, the lse and D rows, the int32 counters), B,
    H, Hkv, S, dh, causal, the element strides of q, k, v, o, dout, dq, dk
    and dv, the head dim of the softmax scale, the window and the soft
    cap."""
    B, H, S, dh = q.shape
    ts = (q, k, v, o, dout, *grads)
    return _BWD_CALL.pack(
        *(t.data_ptr() for t in (q, k, v, o, dout, lse, *grads, *scratch)),
        B, H, k.shape[1], S, dh, int(causal),
        *(x for t in ts for x in t.stride()), scale_dh, window,
        float(softcap))


@functools.lru_cache(maxsize=None)
def _card(index: int):
    """(compute capability, name) of CUDA device ``index``."""
    p = torch.cuda.get_device_properties(index)
    return (p.major, p.minor), p.name


def _require_wgmma(name: str, *tensors) -> None:
    """Raise unless ``tensors`` are bf16 on one sm_90 CUDA device (the
    Hopper kernels' library holds sm_90a code only)."""
    dev = tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError(f"q must be on a CUDA device, got {dev}")
    if any(t.device != dev or t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"{name}: inputs must be bf16 on {dev}, got "
                         f"{[(t.dtype, str(t.device)) for t in tensors]}")
    cap, card = _card(dev.index)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: bf16 at dh {WGMMA_HEAD_DIMS} "
                           f"runs on wgmma, which needs an sm_90 card; "
                           f"{card} has compute capability {cap}")


def _raise_strides(name: str, err: int, *tensors) -> None:
    if err == INVALID_VALUE:
        raise ValueError(
            f"{name} takes views with unit stride in the last dim, "
            f"16-byte multiples elsewhere and 16-byte aligned bases; got "
            f"strides {[t.stride() for t in tensors]}, bases "
            f"{[t.data_ptr() % 16 for t in tensors]} (mod 16)")


def _flash_wgmma(q, k, v, causal: bool, scale_dh: int, window: int,
                 lse=None, softcap: float = 0.0) -> torch.Tensor:
    _require_wgmma("flash_attention", q, k, v)
    dev = q.device
    out = torch.empty_like(q)   # q's layout where q is dense, else contiguous
    lib, fn = _build.entry("flash_attention", 1, 0, "wgmma")
    # the current stream's raw handle (no Stream object: a few microseconds
    # a call, which the encoders' small grids would pay)
    err = fn(wgmma_call(q, k, v, out, causal, scale_dh, window, lse,
                        softcap),
             torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_strides("flash_attention", err, q, k, v)
    _build.check(lib, "flash_attention", err)
    return out


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the tensor maps read it as it is (unit stride in the
    last dim, the others positive multiples of 8 elements where the dim
    has more than one entry, a 16-byte aligned base; the model's
    ``[B,S,H,dh]`` activations read as ``[B,H,S,dh]``), else a contiguous
    copy (an autograd gradient may come expanded, with zero strides)."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0
        for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    return t if ok else t.contiguous()


def _bwd_wgmma(q, k, v, o, dout, lse, causal: bool, scale_dh: int,
               window: int, softcap: float):
    """The Hopper backward on the callers' views; dq, dk and dv in q's,
    k's and v's layouts (``empty_like``)."""
    _require_wgmma("flash_attention_bwd", q, k, v, o, dout)
    q, k, v, o, dout = (_tma_view(t) for t in (q, k, v, o, dout))
    dev = q.device
    B, H, S, dh = q.shape
    s_pad = -(-S // BQ) * BQ
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    scratch = (torch.empty(B * H * s_pad * dh, dtype=torch.float32,
                           device=dev),
               torch.empty(2 * B * H * s_pad, dtype=torch.float32,
                           device=dev),
               torch.empty(B * H * (s_pad // BQ) + 1, dtype=torch.int32,
                           device=dev))
    lib, fn = _build.entry("flash_attention_bwd", 1, 0, "wgmma")
    err = fn(bwd_wgmma_call(q, k, v, o, dout, lse.contiguous(), grads,
                            scratch, causal, scale_dh, window, softcap),
             torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_strides("flash_attention_bwd", err, q, k, v, o, dout, *grads)
    _build.check(lib, "flash_attention_bwd", err)
    return grads


def _softcap(softcap) -> float:
    cap = float(softcap)
    if not cap >= 0:
        raise ValueError(f"softcap must be >= 0 (0: none), got {softcap}")
    return cap


def _lse_out(q: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int = 0,
                         with_lse: bool = False, softcap: float = 0.0):
    """q:[B,H,S,dh], k/v:[B,Hkv,S,dh], one dtype (bf16 or fp32) on one CUDA
    device; H % Hkv == 0, 1 <= dh <= 256; ``window > 0`` masks the keys
    ``j <= i - window`` (0 or less: no window, as the reference reads
    it); ``softcap > 0`` caps the scaled logits to ``softcap * tanh(s /
    softcap)`` (0: none). bf16 at dh 64/128 takes views
    with unit stride in dh and other strides in 16-byte multiples (the
    output keeps q's layout); the other paths copy to contiguous. A dh
    outside ``HEAD_DIMS`` runs at ``padded_head_dim(dh)`` on zero-padded
    copies of q, k and v, with the softmax scale of the true dh, and
    returns a view of the true columns. Returns ``[B,H,S,dh]`` in q's
    dtype; with ``with_lse`` also each row's natural log-sum-exp of its
    scaled logits, fp32 ``[B,H,S]`` (what the backward reads)."""
    _check_shapes(q, k, v)
    window, softcap = max(int(window), 0), _softcap(softcap)
    dh = q.shape[3]
    width = padded_head_dim(dh)
    if width != dh:
        pad = (0, width - dh)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    lse = _lse_out(q) if with_lse else None
    if q.dtype == torch.bfloat16 and width in WGMMA_HEAD_DIMS:
        out = _flash_wgmma(q, k, v, causal, dh, window, lse, softcap)
    else:
        dev = q.device
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _build.require(q, "q", tuple(_ENTRY), 4, dev)
        _build.require(k, "k", (q.dtype,), 4, dev)
        _build.require(v, "v", (q.dtype,), 4, dev)
        B, H, S = q.shape[:3]
        lib, fn = _build.entry("flash_attention", 5, 8, _ENTRY[q.dtype], 1)
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, H, k.shape[1], S,
                 width, int(causal), dh, window, softcap,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "flash_attention", err)
    from repro_torch.kernels.ops import count_launch  # ops imports this module
    count_launch("flash_attention")
    out = out if width == dh else out[..., :dh]
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal: bool,
                             window: int = 0, softcap: float = 0.0):
    """The gradients ``(dq [B,H,S,dh], dk, dv [B,Hkv,S,dh])`` of attention
    from its inputs, output ``o``, the output's gradient ``dout`` and the
    forward's log-sum-exp ``lse`` (fp32 ``[B,H,S]``), one dtype (bf16 or
    fp32) on one CUDA device, by ``csrc/flash_attention_bwd.cu``. bf16 at
    dh 64/128 (after padding) runs the Hopper design on the callers' views
    (unit stride in dh, 16-byte multiples elsewhere) and returns the
    gradients in q's, k's and v's layouts; the other paths copy the five
    tensors to contiguous and return contiguous gradients. A dh off
    ``HEAD_DIMS`` runs zero-padded as the forward pads it (zero columns add
    nothing to the true columns' gradients) and returns views of the true
    columns."""
    _check_shapes(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    window, softcap = max(int(window), 0), _softcap(softcap)
    dh = q.shape[3]
    width = padded_head_dim(dh)
    if width != dh:
        pad = (0, width - dh)
        q, k, v, o, dout = (torch.nn.functional.pad(t, pad)
                            for t in (q, k, v, o, dout))
    dev = q.device
    _build.require(lse.contiguous(), "lse", (torch.float32,), 3, dev)
    if q.dtype == torch.bfloat16 and width in WGMMA_HEAD_DIMS:
        dq, dk, dv = _bwd_wgmma(q, k, v, o, dout, lse, causal, dh, window,
                                softcap)
    else:
        q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
        _build.require(q, "q", tuple(_ENTRY), 4, dev)
        for name, t in (("k", k), ("v", v), ("o", o), ("dout", dout)):
            _build.require(t, name, (q.dtype,), 4, dev)
        lse = lse.contiguous()
        B, H, S = q.shape[:3]
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v))
        dsum = torch.empty_like(lse)   # the kernel's scratch: D
        lib, fn = _build.entry("flash_attention_bwd", 10, 8, _ENTRY[q.dtype],
                               1)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, H,
                 k.shape[1], S, width, int(causal), dh, window, softcap,
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
                       causal: bool, window: int, with_lse: bool,
                       softcap: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_cuda`` as a library operation -> ``(out, lse)``,
    the lse ``[0]`` unless ``with_lse``. Its autograd is the backward
    kernel (``flash_attention_bwd_op``, which needs ``with_lse``); on
    ``meta`` tensors it gives the shapes (``roofline.op_cost`` registers
    its FLOP formula)."""
    if with_lse:
        return flash_attention_cuda(q, k, v, causal, window, with_lse=True,
                                    softcap=softcap)
    out = flash_attention_cuda(q, k, v, causal, window, softcap=softcap)
    return out, q.new_empty(0, dtype=torch.float32)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, with_lse, softcap=0.0):
    lse_shape = q.shape[:3] if with_lse else (0,)
    return (q.new_empty(q.shape),
            q.new_empty(lse_shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, dout: torch.Tensor,
                           lse: torch.Tensor, causal: bool, window: int,
                           softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``flash_attention_bwd_cuda`` as a library operation."""
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal,
                                          window, softcap)
    return dq, dk, dv


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, dout, lse, causal, window, softcap=0.0):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, with_lse, softcap = inputs
    if not with_lse:
        raise ValueError("flash_attention_op differentiates only with_lse")
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.window, ctx.softcap = causal, window, softcap


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, dout, lse, ctx.causal,
                                        ctx.window, ctx.softcap)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)
