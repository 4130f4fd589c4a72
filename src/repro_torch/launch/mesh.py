"""Device meshes: the port of ``repro.launch.mesh``.

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with named dims
over the default process group, which the caller starts (``torchrun``, or
``init_process_group`` with its address, world size and rank); it starts
one itself, from the ``torchrun`` environment, only when none is running.
Importing this module touches no process group and no environment.

The backend is explicit: NCCL for ``cuda``, gloo for ``cpu``. Several
ranks on one card (NCCL refuses two ranks on one device) pass
``backend="gloo"``. The world size must equal the mesh's size: a mesh is
never shrunk to fit.

Single pod = 16 x 16 ("data", "model"), 256 cards; multi-pod adds a leading
"pod" dim (2 x 16 x 16 = 512). Data parallelism spans ("pod", "data"), so
scaling to N pods grows only the pod dim; tensor parallelism stays inside
a pod.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None,
              backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` on
    ``device_type`` (default ``cuda``). A process group already running
    must have been started on ``backend`` (default: NCCL for ``cuda``,
    gloo for ``cpu``) and have exactly the mesh's size of ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    device_type = device_type or "cuda"
    backend = backend or BACKENDS.get(device_type)
    if backend is None:
        raise ValueError(f"no default backend for {device_type!r}: pass one")
    size = 1
    for s in shape:
        size *= s
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ or size != 1:
            dist.init_process_group(backend)   # torchrun's environment
        else:   # one process, no launcher: a group of one in memory
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    running = dist.get_backend()
    if running != backend and not (backend == "gloo"
                                   and "gloo" in str(running)):
        raise ValueError(f"the process group runs {running!r}, the mesh "
                         f"asks for {backend!r}")
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"world size {world} != mesh size {size} "
                         f"{shape}: a mesh is never shrunk to fit")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None,
                         backend: Optional[str] = None):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type, backend)


def make_host_mesh(device_type: Optional[str] = None,
                   backend: Optional[str] = None):
    """The one-device mesh (1, 1) ("data", "model")."""
    return make_mesh((1, 1), ("data", "model"), device_type, backend)
