"""Training entry point of the port:
``python -m repro_torch.launch.train --arch llama3_8b --smoke``.

The loop: the deterministic data pipeline -> the train step
(``train.train_step``) -> heartbeats and straggler records -> periodic
asynchronous checkpoints -> on relaunch, restart from the latest
checkpoint. Everything runs on ``--device`` (default ``cuda``; ``cpu``
for the smoke configs on a host). The flags are the reference's
(``repro.launch.train``); ``--log-every`` prints the loss as it goes.

The step runs under a device mesh, as the reference's does: the host mesh
(1, 1) by default (a process group of one; the state stays unsharded),
or with ``--production-mesh`` the (16, 16) ("data", "model") mesh, with
``--multi-pod`` (2, 16, 16) ("pod", "data", "model"), or with ``--mesh
D,M`` a (D, M) ("data", "model") mesh, under ``torchrun`` with a world
size equal to the mesh's (each rank on ``cuda:LOCAL_RANK``; gloo for
``--device cpu``). Every family trains sharded: the dense, MoE
(expert-parallel) and vlm transformers, Whisper, xLSTM and Zamba2. The train state is then placed by
``distributed.partition`` (TP by the name rules, ZeRO-1 moments), each
data rank reads its own batch shard (``train.data``'s ``shard`` and
``n_shards``), and rank 0 prints and writes the checkpoints.

On the card the step runs with deterministic algorithms (cuBLAS's fixed
workspace, ``torch.use_deterministic_algorithms``; the attention kernels
use no atomics), so a relaunch from a checkpoint ends bit for bit where
an uninterrupted run ends. The vlm and Whisper families train on zero
embeddings and zero frames: their frontends are stubs, as in serving.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.distributed import partition as pt
from repro_torch.distributed.fault_tolerance import (
    FaultTolerantRunner, HeartbeatTracker, StragglerDetector)
from repro_torch.distributed.sharding import sharding_rules
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                    make_production_mesh)
from repro_torch.monitor.monitor import MonitorConfig, ResourceMonitor
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, batch_iterator
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

# <repo>/build/ckpt_<arch>: src/repro_torch/launch/train.py -> parents[3]
CKPT_ROOT = Path(__file__).resolve().parents[3] / "build"


def device_batch(batch, cfg, device) -> dict:
    """A numpy batch as tensors on ``device``, with the stub frontends'
    zero inputs (a vlm's ``embeds``, Whisper's ``frames``)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    lead = out["tokens"].shape
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "vlm":
        out["embeds"] = torch.zeros((*lead, cfg.d_model), dtype=dtype,
                                    device=device)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((*lead[:-1], cfg.encoder_seq,
                                     cfg.d_model), dtype=dtype, device=device)
    return out


def place_batch(local: dict, mesh, global_batch: int,
                row_dim: int = 0) -> dict:
    """A data rank's batch shard (its rows along ``row_dim``: 1 for
    micro-batched ``[accum, rows, ...]`` leaves) as DTensors of the global
    batch, placed by ``batch_specs`` (rows over ("pod", "data"),
    replicated over "model")."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    n = pt.dp_size(mesh)

    def full(shape):
        shape = list(shape)
        shape[row_dim] *= n
        return torch.empty(shape, device="meta")

    shapes = {k: full(v.shape) for k, v in local.items()}
    specs = pt.batch_specs(shapes, mesh, global_batch)
    return {k: DTensor.from_local(v, mesh, placements(specs[k], mesh),
                                  run_check=False, shape=shapes[k].shape,
                                  stride=shapes[k].stride())
            for k, v in local.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="D,M: a (data, model) mesh of that shape")
    ap.add_argument("--monitor-out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the loss every N steps (0: never)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if args.mesh:
        mesh = make_mesh(tuple(int(v) for v in args.mesh.split(",")),
                         ("data", "model"), device.type)
    elif args.production_mesh or args.multi_pod:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
    else:
        mesh = make_host_mesh(device_type=device.type)
    try:
        with sharding_rules(mesh):
            return _train(args, device, mesh)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _data_shard(mesh):
    """(this rank's data shard, the number of data shards)."""
    shard = 0
    for a in pt.dp_axes(mesh):
        shard = shard * pt.mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return shard, pt.dp_size(mesh)


def _train(args, device, mesh):
    import torch.distributed as dist

    lead = dist.get_rank() == 0
    if device.type == "cuda":
        # bit-for-bit restarts: a fixed cuBLAS workspace (read when cuBLAS
        # first starts in this process) and deterministic kernels
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 10, 1)),
        accum_steps=args.accum, compress_grads=args.compress_grads)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      seed=args.seed)

    monitor = ResourceMonitor(MonitorConfig(out_path=args.monitor_out)).start()
    ckpt = CheckpointManager(
        args.ckpt_dir or str(CKPT_ROOT / f"ckpt_{args.arch}"), keep=3)
    hb = HeartbeatTracker(n_hosts=1)
    sd = StragglerDetector()

    state = init_train_state(args.seed, cfg, tcfg, device, mesh)
    restored, start_step = ckpt.restore_latest(state)
    if restored is not None:
        if lead:
            print(f"restored checkpoint at step {start_step}")
    else:
        start_step = 0
    train_step = make_train_step(cfg, tcfg)
    logged = {"step": start_step}

    def step_fn(state, batch):
        state, metrics = train_step(state, batch)
        logged["step"] += 1
        if lead and args.log_every and logged["step"] % args.log_every == 0:
            print(f"step {logged['step']} loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
        return state, metrics

    shard, n_shards = _data_shard(mesh)

    def batches():
        for b in batch_iterator(dcfg, cfg, start_step=start_step,
                                shard=shard, n_shards=n_shards):
            if args.accum > 1:
                b = {k: v.reshape(args.accum, -1, *v.shape[1:])
                     for k, v in b.items()}
            b = device_batch(b, cfg, device)
            if mesh.size() > 1:   # this rank's rows of the global batch
                b = place_batch(b, mesh, args.global_batch,
                                int(args.accum > 1))
            yield b

    runner = FaultTolerantRunner(ckpt, hb, sd, ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    state, step, metrics = runner.run(
        state, step_fn, batches(), args.steps, start_step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    monitor.stop()
    if metrics is None:   # nothing left to run past the checkpoint
        if lead:
            print(f"trained 0 steps: the checkpoint is at step {start_step}")
        return None
    if not lead:
        return float(metrics["loss"])
    tokens = (step - start_step) * args.global_batch * args.seq_len
    print(f"trained {step - start_step} steps in {wall:.1f}s "
          f"({tokens / max(wall, 1e-9):.0f} tok/s), "
          f"final loss={float(metrics['loss']):.4f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
