"""Logical-axis sharding: the port of ``repro.distributed.sharding``.

Models are written against *logical* axis names ("batch", "seq", "heads",
"ff", "vocab", ...). A ``sharding_rules`` context maps them to the named
dims of a ``DeviceMesh``; ``logical_spec`` turns a shape and its logical
names into a spec (one entry a tensor dim: ``None``, a mesh dim's name or
a tuple of names), with the reference's divisibility and prefix logic, and
``placements`` turns a spec into DTensor placements. ``constrain`` is the
counterpart of ``jax.lax.with_sharding_constraint``: without a mesh, or on
a one-device mesh, it returns its input; on a larger mesh it redistributes
a DTensor to the spec's placements (a plain tensor there raises: its
caller forgot to place its inputs).

A mesh argument may be a ``DeviceMesh`` (its ``mesh_dim_names``) or any
object with a ``shape`` mapping of dim name to size, as the reference's
tests pass.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# default logical -> mesh-dim mapping. "pod" is folded into the batch axes
# when present (multi-pod meshes extend data parallelism across pods).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": "model",          # sequence-parallel residuals (SP)
    "embed": None,           # residual feature dim replicated
    "heads": "model",        # TP over attention heads
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",           # TP over MLP hidden
    "experts": "model",      # expert parallelism
    "expert_ff": None,
    "vocab": "model",
    "zero": ("pod", "data"),  # ZeRO-1 optimizer-state sharding axis
    "kv_seq": "model",       # decode-time KV cache sequence sharding
    "corpus": ("pod", "data"),  # vector-db corpus sharding
}


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Axis] = dict(DEFAULT_RULES)


_STATE = _State()


@contextmanager
def sharding_rules(mesh, rules: Optional[Dict[str, Axis]] = None):
    """Activate a mesh and a logical-rule mapping for model code (this
    thread only)."""
    prev = (_STATE.mesh, _STATE.rules)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _STATE.mesh, _STATE.rules = mesh, merged
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def active_mesh():
    return _STATE.mesh


def active_rules():
    """``(mesh, rules)`` of this thread, which ``sharding_rules(*...)``
    re-enters elsewhere: autograd runs a CUDA backward (and with it a
    checkpointed block's recomputation) on its own thread."""
    return _STATE.mesh, dict(_STATE.rules)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or of a mock mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: Dict[str, int], axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return shape.get(axis, 1)
    n = 1
    for a in axis:
        n *= shape.get(a, 1)
    return n


def _filter_axes(shape: Dict[str, int], axis: Axis) -> Axis:
    """Drop mesh dims that this mesh lacks (e.g. 'pod' on one pod)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in shape else None
    kept = tuple(a for a in axis if a in shape)
    return kept if kept else None


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh=None, rules: Optional[Dict[str, Axis]] = None) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the ``logical``
    names: each name's mesh dims where their size divides the tensor dim,
    else the longest prefix of them that does, else ``None``; a mesh dim
    is used once. Without a mesh every entry is ``None``."""
    mesh = mesh if mesh is not None else _STATE.mesh
    rules = rules or _STATE.rules
    if mesh is None:
        return (None,) * len(shape)
    ms = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axis = _filter_axes(ms, rules.get(name)) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = tuple(a for a in axes if a not in used)
        size = _axis_size(ms, axes)
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            # progressively shorter prefixes of the axis tuple
            ok = None
            for k in range(len(axes) - 1, 0, -1):
                sub = axes[:k]
                s = _axis_size(ms, sub)
                if s > 1 and dim % s == 0:
                    ok = sub if len(sub) > 1 else sub[0]
                    used.update(sub)
                    break
            out.append(ok)
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: mesh dim
    ``a`` of entry ``i`` becomes ``Shard(i)`` (several mesh dims on one
    tensor dim shard it in mesh-dim order, major first); the others
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {tuple(names)}")
        for i in order:
            out[i] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (a plain tensor every rank computes alike: positions, masks,
    tables) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor; else ``t`` itself. DTensor refuses to mix the two kinds in
    one operation."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, *logical: Optional[str]):
    """Redistribute ``x`` to its logical names' placements on the active
    mesh; the identity without a mesh or on a one-device mesh."""
    mesh = _STATE.mesh
    if mesh is None or mesh.size() == 1:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constrain on a {mesh.size()}-device mesh got a plain tensor "
            f"of shape {tuple(x.shape)}: place the inputs as DTensors")
    want = placements(logical_spec(x.shape, logical, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
