"""Checkpoints: an npz of the state's arrays + a JSON manifest, written
asynchronously, restart from the latest. The port of
``repro.train.checkpoint``.

  * ``save()`` is atomic: written to a temporary directory, then renamed,
    so a crash mid-write never corrupts the latest checkpoint;
  * the write runs on a background thread (training continues; ``wait()``
    joins); the device-to-host copy happens before ``save`` returns;
  * ``restore_latest()`` finds the newest complete checkpoint and fills a
    template state with it, returning ``(state, step)``: the restart path;
  * ``keep`` bounds disk use by pruning old checkpoints;
  * arrays are keyed by their path in the state (``params.<name>``,
    ``opt.mu.<name>``, ``opt.step``, ``err.<name>``), and a shape that does
    not match the template's is rejected.

bf16 tensors are stored as their uint16 bits (numpy has no bfloat16) with
the dtype in the manifest. The manifest is JSON (the reference's is
msgpack, which the port does not need).

A sharded state (DTensor leaves) is saved as full tensors: every rank
takes part in gathering each leaf (``save`` is collective), and rank 0
alone writes. On restore every rank reads the same files and keeps its
own shard of each leaf at the template's placement, so a restart on the
mesh ends bit for bit where an uninterrupted run ends, and a checkpoint
loads on any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _leaves(state, prefix: str = ""):
    """(key, tensor) of every tensor in the state's nested dicts, the
    ``model`` entry excepted (its parameters are ``params``)."""
    for key, value in state.items():
        if key == "model":
            continue
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, path + ".")
        elif isinstance(value, torch.Tensor):
            yield path, value


def _is_dtensor(t) -> bool:
    from repro_torch.distributed.sharding import is_dtensor
    return is_dtensor(t)


def _writer() -> bool:
    """Rank 0 writes (every process when no process group runs)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    if _is_dtensor(t):
        t = t.full_tensor()   # collective: every rank gathers the leaf
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, state, step: int, blocking: bool = False) -> None:
        """Snapshot to host memory now, write to disk on a thread."""
        flat = {k: (_to_host(t), _dtype_name(t)) for k, t in _leaves(state)}
        if not _writer():
            return
        self.wait()   # one write at a time (the same step may be saved twice)
        if blocking:
            self._write(flat, step)
            return
        self._thread = threading.Thread(
            target=self._write, args=(flat, step), daemon=True)
        self._thread.start()

    def _write(self, flat: Dict[str, Tuple[np.ndarray, str]],
               step: int) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": list(flat),
            "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
            "dtypes": {k: dt for k, (_, dt) in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._prune()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self) -> None:
        ckpts = self.list_checkpoints()
        for step in ckpts[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{step:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def list_checkpoints(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    @torch.no_grad()
    def restore(self, template, step: int):
        """Fill the tensors of ``template`` (a state of the same structure)
        in place from checkpoint ``step``; returns the template. Raises on
        a missing key or a shape mismatch, before writing anything."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = np.load(os.path.join(path, "arrays.npz"))
        loaded = []
        for key, t in _leaves(template):
            if key not in manifest["keys"]:
                raise KeyError(f"checkpoint missing {key}")
            arr = arrays[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(t.shape)}")
            if manifest["dtypes"][key] == "bfloat16":
                src = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                src = torch.from_numpy(arr.copy())
            if _is_dtensor(t):   # this rank's shard of the full leaf
                from torch.distributed.tensor import distribute_tensor
                src = distribute_tensor(src.to(t.device), t.device_mesh,
                                        t.placements, src_data_rank=None)
            loaded.append((t, src))
        for t, src in loaded:
            t.copy_(src)
        return template

    def restore_latest(self, template) -> Tuple[Optional[object], int]:
        ckpts = self.list_checkpoints()
        if not ckpts:
            return None, -1
        step = ckpts[-1]
        return self.restore(template, step), step
