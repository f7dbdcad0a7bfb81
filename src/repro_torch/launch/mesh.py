"""Production mesh builders (port of ``repro/launch/mesh.py``): functions,
never module-level constants, so importing this module touches no
process group.

Both run over the default process group the caller initialized.  The
dry-run initializes one process with torch's ``fake`` backend
(``init_fake_world``): 256 or 512 ranks of which this process is rank 0,
whose collectives execute nothing.  The tests give ``make_host_mesh``
gloo ranks, the card NCCL.
"""
from __future__ import annotations

import contextlib


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data",
    "model")`` over the initialized world (256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """``(world // model, model)`` ``("data", "model")`` over the
    initialized world (tests and examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"world {world} does not divide into model={model}")
    return init_device_mesh(_device_type(device_type),
                            (world // model, model),
                            mesh_dim_names=("data", "model"))


def make_mesh(shape, axes, device_type: str | None = None):
    """A mesh of any shape over the initialized world (smoke runs of the
    dry-run on small fake worlds)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def init_fake_world(world_size: int):
    """A process group of ``world_size`` ranks on torch's ``fake`` backend
    (this process rank 0; collectives return without executing), torn
    down on exit so that no later code in the process sees it.  Refuses
    to run over a group that is already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
