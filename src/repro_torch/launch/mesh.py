"""Host meshes of ranks (port of ``repro/launch/mesh.py``).

``make_host_mesh`` lays the world's ranks out as a ``(data, model)``
grid (``core.transport.GridMesh``): data parallelism over the first
axis, tensor parallelism over the second.  The reference's
``make_production_mesh`` (a 256- or 512-chip pod for the dry-run tools)
has no counterpart yet: it waits with those tools.
"""
from __future__ import annotations

from repro_torch.core.transport import GridMesh, make_grid_mesh


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
    """The batch-sharding axes for this mesh (pod joins data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
