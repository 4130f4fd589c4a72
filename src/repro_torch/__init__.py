"""PyTorch/CUDA port of the RAGPerf reproduction.

Mirrors the module layout of the JAX package ``repro`` (the reference,
which stays as it is) and imports nothing of it: modules the port needs
are copied here. Every TPU kernel on a ported path is a hand-written CUDA
kernel for Hopper under ``csrc/``, built at first use
(``repro_torch.kernels._build``); its plain PyTorch version
(``repro_torch.kernels.ref``) runs on CPU tensors.
"""
