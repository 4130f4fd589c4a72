"""PyTorch/CUDA port of the RAGPerf reproduction.

Mirrors the module layout of the JAX package ``repro`` (the reference,
which stays as it is) and imports nothing of it: modules the port needs
are copied here. Every TPU kernel on a ported path is a hand-written CUDA
kernel for Hopper under ``csrc/``, built at first use
(``repro_torch.kernels._build``); its plain PyTorch version
(``repro_torch.kernels.ref``) runs on CPU tensors.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device a port component runs on: ``None`` means ``cuda``, and
    asking for CUDA where there is none raises. A CUDA device comes back
    with its index (``cuda`` is the current card), so it compares equal to
    the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the card unless the "
            "caller passes device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): a host clock read after it includes the device's time."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_same_device(owner: str, model, device: torch.device) -> None:
    """Raise unless ``model`` (a component's model, given or drawn) lies on
    the component's ``device``: a component never moves its inputs to a
    model elsewhere."""
    if model.device != device:
        raise ValueError(f"{owner} runs on {device} but its model lies on "
                         f"{model.device}")
