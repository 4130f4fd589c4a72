"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
never loads a stale library. ``build_all`` starts one nvcc per source, all at
once. Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/kernels: src/repro_torch/kernels/_build.py -> parents[3]
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("topk_search", "ivf_topk", "quant_score", "sq8_topk", "pq_topk",
           "flash_attention", "flash_attention_bwd", "topk_large")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the .cu and shared .cuh files
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together. Returns ``{name: ptxas report}`` for
    what was compiled; raises with nvcc's output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


@functools.lru_cache(maxsize=None)
def entry(name: str, n_ptr: int, n_int: int, dtype: str = "f32"):
    """``(library, C entry point <name>_<dtype>)`` of ``csrc/<name>.cu``
    (``dtype`` names the operands' type: "f32", "bf16", "s8" or "u8"),
    typed as taking ``n_ptr`` pointers,
    ``n_int`` ints and the stream and returning the CUDA error code."""
    lib = library(name)
    fn = getattr(lib, f"{name}_{dtype}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def tile_rows(name: str) -> int:
    """Corpus rows per block of a tile scan (``<name>_tile_rows``): its
    output holds one top-k list per tile."""
    fn = getattr(library(name), f"{name}_tile_rows")
    fn.restype = ctypes.c_int
    return fn()


@functools.lru_cache(maxsize=None)
def smem_bytes(name: str, d: int, k: int) -> int:
    """Dynamic shared memory per block that ``csrc/<name>.cu`` requests
    for rows of width ``d`` and lists of ``k`` (``<name>_smem_bytes``)."""
    fn = getattr(library(name), f"{name}_smem_bytes")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d, k)


def require(t, name: str, dtypes, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with one
    of ``dtypes`` and ``ndim`` dims, 16-byte aligned (the kernels read
    rows with 16-byte loads)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check(lib: ctypes.CDLL, prefix: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
