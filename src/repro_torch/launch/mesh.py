"""Production mesh construction.

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module starts no process group.  The production meshes are
the reference's fleet: one pod of 16x16 = 256 chips, axes (data, model),
or two pods, 2x16x16 = 512 chips, axes (pod, data, model) — the "pod" axis
carries pure data parallelism across the inter-pod links.  No host holds
that many devices, so the mesh is laid over a *fake* process group of 256
or 512 ranks in this one process (``torch.distributed``'s ``fake``
backend: collectives are recorded by the caller and move no data); the
dry-run places ``meta`` tensors on it.  The reference forces 512 host
devices on XLA for the same purpose.
"""

from __future__ import annotations

import math

import torch


def _fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0),
    initialized at the first call and reused while its size fits; a fake
    group of another size is replaced, a real one raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is running; the production "
                f"mesh needs {world}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a ``DeviceMesh`` on a fake
    process group (see the module's docstring)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    _fake_world(world)
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """A ``(data, model)`` mesh over the process group that is running
    (tests / examples); ``device_type`` defaults to ``cuda`` under NCCL,
    else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))
