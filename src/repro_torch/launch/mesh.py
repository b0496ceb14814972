"""Host meshes of ranks (port of ``repro/launch/mesh.py``).

``make_host_mesh`` lays the world's ranks out as a ``(data, model)``
grid (``core.transport.GridMesh``): data parallelism over the first
axis, tensor parallelism over the second.  ``make_production_mesh`` is
the dry run's (``launch.dryrun``) 256- or 512-rank mesh, which can be
traced but never run.
"""
from __future__ import annotations

from repro_torch.core.transport import GridMesh, make_grid_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh as a ``DeviceMesh`` seen from rank
    0: ``(16, 16)`` over ``("data", "model")`` (256 ranks), or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` (512).

    It lies on a ``fake`` process group (``FakeStore``), initialised here
    when no group exists; an existing group of another size raises.  The
    fake backend's collectives move nothing and return at once, so the
    mesh can only be traced (DTensors on fake tensors, as the dry run
    does), never run.  On DGX-style nodes a 16-wide model axis spans two
    8-GPU NVLink domains, so a collective term taken at
    ``config.HW.ici_bw_per_link`` is a lower bound."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    elif dist.get_world_size() != n:
        raise ValueError(f"a process group of {dist.get_world_size()} "
                         f"ranks exists; the production mesh needs {n}")
    return init_device_mesh(str(device), shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda") -> GridMesh:
    """Small grid over whatever ranks exist (tests / examples): ``data``
    clamped to the world's rank count, ``model`` to what is left of it,
    as the reference clamps to its devices.  A clamped grid that leaves
    ranks out raises (``make_grid_mesh``)."""
    import torch.distributed as dist
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    data = min(data, n)
    model = min(model, max(1, n // data))
    return make_grid_mesh(data, model, tenant_axis="data",
                          model_axis="model", device=device)


def dp_axes(mesh) -> tuple:
    """The batch-sharding axes for this mesh (pod joins data): a grid of
    ranks or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)
