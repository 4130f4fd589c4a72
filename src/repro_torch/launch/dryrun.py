"""Multi-pod dry-run: lower every (arch x shape x mesh) cell on a fake
process group, without the hardware. The port of ``repro.launch.dryrun``.

It proves the distribution is coherent: every parameter, optimizer, batch
and cache spec places on the mesh, and every operation of the step has a
sharding (a mismatch or an operation DTensor cannot shard raises here).
Each cell's step runs once on ``meta`` DTensors (shapes only: nothing is
allocated) on a mesh of 256 ranks (16 x 16) or 512 (2 x 16 x 16), of which
this process is rank 0 on the ``fake`` backend (its collectives return
without moving data). The report holds one rank's FLOPs and bytes, the
link bytes of its collectives and the three-term roofline
(``roofline.analysis``), as JSON under ``--out``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_mesh, production_shape
from repro_torch.models.config import SHAPES
from repro_torch.roofline.analysis import feature_dims, roofline_report
from repro_torch.train.train_step import TrainConfig

OPTIMIZATIONS = {
    # the reference's hill-climb changes, applied with --opt (the paper's
    # baseline stays the default)
    "mlstm_chunk": lambda cfg: cfg.replace(mlstm_chunk=256)
    if cfg.family == "ssm" else cfg,
}
COMPILE_REASON = ("no ahead-of-time compile: the port runs eagerly, and "
                  "its kernels are built on the card at first use")
TEMPS_REASON = ("temporaries exist only when the step runs on the card "
                "(torch.cuda.max_memory_allocated)")


def apply_optimizations(cfg):
    for fn in OPTIMIZATIONS.values():
        cfg = fn(cfg)
    return cfg


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of this rank's shard of ``t`` (all of a plain tensor)."""
    from repro_torch.distributed.sharding import is_dtensor

    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def device_bytes(args, state, outputs) -> Dict[str, Optional[int]]:
    """Per-device bytes of the step's arguments (its placed inputs and
    state), outputs, and of the outputs that are arguments updated in
    place (``aliased``), from the local shards."""
    held = {id(t): t for t in (*_tensors(args), *_tensors(state))}
    out = {id(t): t for t in _tensors(outputs)}
    return {
        "arguments": sum(local_bytes(t) for t in held.values()),
        "outputs": sum(local_bytes(t) for t in out.values()),
        "temps": None,
        "temps_reason": TEMPS_REASON,
        "aliased": sum(local_bytes(t) for i, t in out.items() if i in held),
    }


class _FakeGroup:
    """A ``fake``-backend process group of ``size`` ranks (this process is
    rank 0) for the duration of a cell, unless one of that size runs."""

    def __init__(self, size: int):
        self.size = size
        self.started = False

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            if dist.get_world_size() != self.size:
                raise ValueError(f"a process group of {dist.get_world_size()}"
                                 f" ranks runs; the mesh needs {self.size}")
            return self
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.size)
        self.started = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.started:
            dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = "build/dryrun", verbose: bool = True,
             train_cfg: TrainConfig = None, tag: str = "", opt: bool = False,
             smoke: bool = False, mesh_shape: Optional[Sequence[int]] = None,
             mesh_axes: Optional[Sequence[str]] = None):
    """Lower one cell and return its report (the reference's keys, and
    ``status``). ``smoke`` takes the arch's reduced config, and
    ``mesh_shape``/``mesh_axes`` another mesh than the production one (a
    test's small fake mesh)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    if opt:
        cfg = apply_optimizations(cfg)
        tag = tag or "_opt"
    shape = SHAPES[shape_name]
    if not configs.supports_shape(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k requires a sub-quadratic token path "
                          "(full-attention arch)"}
    if mesh_shape is None:
        mesh_shape, mesh_axes = production_shape(multi_pod)
    n_chips = 1
    for s in mesh_shape:
        n_chips *= s
    with _FakeGroup(n_chips):
        mesh = make_mesh(mesh_shape, mesh_axes, "cpu", "fake")
        t0 = time.perf_counter()
        cell = specs_lib.build_cell(cfg, shape, mesh, train_cfg=train_cfg)
        cost, args, out = specs_lib.lower_cell(cell, mesh, shape.seq_len,
                                               feature_dims(cfg))
        t_lower = time.perf_counter() - t0
        state = cell.state if cell.kind == "train" else \
            dict(cell.state.named_parameters())
        per_device = device_bytes(args, state, out)
    report = roofline_report(cfg, shape, n_chips, cost=cost)
    report.update({
        "status": "ok",
        "mesh": "x".join(str(s) for s in mesh_shape),
        "multi_pod": multi_pod,
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "compile_s_reason": COMPILE_REASON,
        "per_device_bytes": per_device,
        "n_collectives": dict(cost.n_collectives),
    })
    if verbose:
        gib = 2 ** 30
        print(f"[{arch} x {shape_name} x {report['mesh']}] kind={cell.kind}"
              f" lowered in {t_lower:.1f} s")
        print(f"  per device: args={per_device['arguments'] / gib:.2f}GiB "
              f"out={per_device['outputs'] / gib:.2f}GiB temp=not measured")
        print(f"  cost: flops/chip={report['flops_per_chip']:.3e} "
              f"bytes/chip={report['bytes_per_chip']:.3e} "
              f"link bytes/chip={report['collective_bytes_per_chip']:.3e}")
        print(f"  roofline: compute={report['compute_s'] * 1e3:.2f}ms "
              f"memory={report['memory_s'] * 1e3:.2f}ms "
              f"collective={report['collective_s'] * 1e3:.2f}ms "
              f"-> {report['bottleneck']}-bound, "
              f"useful={report['useful_flop_ratio']:.2f}, "
              f"roofline_frac={report['roofline_fraction']:.2f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        mesh_tag = "pod2" if multi_pod else "pod1"
        name = f"{arch}_{shape_name}_{mesh_tag}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's optimization set")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in configs.ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures, n_ok = [], 0
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, multi_pod=args.multi_pod,
                         out_dir=args.out, opt=args.opt)
            if r["status"] == "skipped":
                print(f"[{arch} x {shape}] SKIP: {r['reason']}")
            else:
                n_ok += 1
        except Exception as e:   # report every failing cell, then fail
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print(f"dry-run ok: {n_ok} cells lowered, {len(cells) - n_ok} skipped")


if __name__ == "__main__":
    main()
