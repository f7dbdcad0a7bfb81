"""Mesh axis conventions (port of ``repro/distributed/mesh.py``).

Production meshes (``launch/mesh.py`` builds them):
  single-pod : (16, 16)      axes ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``.  Conventions used by every sharding rule:
  * ``data_axes`` — the batch/data-parallel axes: ("pod", "data") when a
    pod axis exists, else ("data",).  Batch dims shard over ALL of them.
  * "model" — tensor/expert/table parallelism.  Pods never split a
    tensor: cross-pod traffic is only the gradient reduction over the pod
    axis.

A spec is the reference's PartitionSpec as a plain tuple: one entry a
tensor dim, each None (replicated), an axis name, or a tuple of axis
names (the dim sharded over all of them, the first the major one).
``placements`` turns it into DTensor placements, one a mesh dim.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    names = _names(mesh)
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def model_size(mesh) -> int:
    return axis_size(mesh, "model")


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def entry_size(mesh, entry) -> int:
    return math.prod(axis_size(mesh, a) for a in entry_axes(entry))


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec``: ``Replicate()`` on every mesh dim
    that no entry names, ``Shard(i)`` on each mesh dim that entry ``i``
    names."""
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a not in names:
                raise ValueError(f"axis {a!r} is not in the mesh {names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"axis {a!r} used twice in {spec}")
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def local_shape(mesh, shape, spec) -> tuple[int, ...]:
    """The shape a rank holds of a tensor of ``shape`` placed by ``spec``
    (every sharded dim divisible, as ``sharding.safe_P`` leaves them)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        k = entry_size(mesh, entry)
        if dim % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry} ({k})")
        out.append(dim // k)
    return tuple(out)
