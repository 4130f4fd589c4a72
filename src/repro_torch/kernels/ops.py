"""Kernel dispatch by the device of the inputs.

A CPU tensor goes to the kernel's plain version (``repro_torch.kernels.ref``);
a CUDA tensor goes to the hand-written kernel, which launches or raises.
There is no mode variable and no fallback: the device is the only switch,
so the CPU tests exercise the plain versions and a run on the card
exercises the kernels.

Each kernel wrapper counts its launches (``count_launch``, under one lock:
replica workers on threads launch kernels concurrently); ``launch_counts``
and ``reset_launch_counts`` let a caller show that a run went through them.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_retrieve as _fr
from repro_torch.kernels import quant_score as _qs
from repro_torch.kernels import ref
from repro_torch.kernels import topk_search as _ts


def _device(*tensors: torch.Tensor) -> str:
    """The one device type of ``tensors``: cpu, cuda or (shapes only)
    meta."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _on_cuda(*tensors: torch.Tensor) -> bool:
    dev = _device(*tensors)
    if dev == "meta":
        raise ValueError("unsupported device meta")
    return dev == "cuda"


def topk_search(q, vecs, live, k: int):
    """Exact top-k; see ``ref.topk_search`` for the contract."""
    if _on_cuda(q, vecs, live):
        return _ts.topk_search_cuda(q, vecs, live, k)
    return ref.topk_search(q, vecs, live, k)


def ivf_topk(q, cent, packed_vecs, packed_slot, packed_ok, nprobe: int,
             k: int):
    """IVF over the packed mirror; see ``ref.ivf_topk`` for the contract."""
    if _on_cuda(q, cent, packed_vecs, packed_slot, packed_ok):
        return _fr.ivf_topk_cuda(q, cent, packed_vecs, packed_slot,
                                 packed_ok, nprobe, k)
    return ref.ivf_topk(q, cent, packed_vecs, packed_slot, packed_ok,
                        nprobe, k)


def quant_score(q, codes, scale):
    """SQ-int8 score matrix; see ``ref.quant_score`` for the contract."""
    if _on_cuda(q, codes, scale):
        return _qs.quant_score_cuda(q, codes, scale)
    return ref.quant_score(q, codes, scale)


def sq8_topk(q, codes, scale, live, k: int):
    """SQ-int8 exact top-k; see ``ref.sq8_topk`` for the contract."""
    if _on_cuda(q, codes, scale, live):
        return _fr.sq8_topk_cuda(q, codes, scale, live, k)
    return ref.sq8_topk(q, codes, scale, live, k)


def pq_topk(q, codebook, cent, packed_codes, packed_slot, packed_ok,
            nprobe: int, k: int):
    """PQ-ADC over the packed bucket codes; see ``ref.pq_topk`` for the
    contract."""
    if _on_cuda(q, codebook, cent, packed_codes, packed_slot, packed_ok):
        return _fr.pq_topk_cuda(q, codebook, cent, packed_codes, packed_slot,
                                packed_ok, nprobe, k)
    return ref.pq_topk(q, codebook, cent, packed_codes, packed_slot,
                       packed_ok, nprobe, k)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    softcap: float = 0.0):
    """Grouped-query attention, q:[B,H,S,dh], k/v:[B,Hkv,S,dh], keys
    ``j <= i - window`` masked when ``window > 0``, the scaled logits
    capped to ``softcap * tanh(s / softcap)`` when ``softcap > 0``; see
    ``ref.flash_attention`` for the contract. On the card, where autograd
    records the call (an input that requires grad, grad mode on), it goes
    through ``flash_attention_op``: the forward kernel with its
    log-sum-exp, and the backward kernel for the gradients; otherwise
    (serving) the forward kernel alone. On the CPU the plain version, under
    plain autograd. On ``meta`` tensors the operation's shapes (what
    ``roofline.op_cost`` counts)."""
    dev = _device(q, k, v)
    if dev == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if dev == "cuda" and not grad:
        return _fa.flash_attention_cuda(q, k, v, causal, window,
                                        softcap=softcap)
    return _fa.flash_attention_op(q, k, v, causal, max(int(window), 0),
                                  grad, float(softcap))[0]


KERNELS = ("topk_search", "quant_score", "ivf_topk", "sq8_topk", "pq_topk",
           "flash_attention", "flash_attention_bwd")


class _LaunchCounts:
    """Launches per kernel; one lock, since ``+=`` on a shared count from
    several threads can lose increments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(KERNELS, 0)   # guarded-by: _lock

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(KERNELS, 0)


_COUNTS = _LaunchCounts()


def count_launch(name: str) -> None:
    """Called by a kernel's wrapper where it launches the kernel."""
    _COUNTS.add(name)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return _COUNTS.snapshot()


def reset_launch_counts() -> None:
    _COUNTS.reset()
