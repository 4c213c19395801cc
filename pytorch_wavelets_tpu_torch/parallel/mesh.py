"""Device meshes and process-group setup (port of
``pytorch_wavelets_tpu/parallel/mesh.py``).

Axes convention, as in the JAX package: ('data', 'spatial'), NCHW batches
shard over 'data' and the image W axis over 'spatial'; with
``n_spatial_h > 1`` the mesh is ('data', 'spatial_h', 'spatial') and H
shards over 'spatial_h'.  One rank is one process; the mesh's ranks are
the world's, laid out as the JAX package reshapes its device list.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

__all__ = ["make_mesh", "data_placements", "spatial_placements",
           "placements", "initialize_multihost"]


def make_mesh(n_data: int | None = None, n_spatial: int = 1,
              n_spatial_h: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'spatial') mesh over the world's ranks, or a
    ('data', 'spatial_h', 'spatial') mesh when ``n_spatial_h > 1``.
    ``n_data`` defaults to the ranks left over.  The process group must
    be initialised (:func:`initialize_multihost`, or ``torchrun`` and
    ``torch.distributed.init_process_group``)."""
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // (n_spatial * n_spatial_h)
    if n_data * n_spatial * n_spatial_h != n:
        raise ValueError(
            f"mesh {n_data}x{n_spatial_h}x{n_spatial} != {n} ranks")
    ranks = torch.arange(n)
    if n_spatial_h > 1:
        return DeviceMesh(device_type,
                          ranks.reshape(n_data, n_spatial_h, n_spatial),
                          mesh_dim_names=("data", "spatial_h", "spatial"))
    return DeviceMesh(device_type, ranks.reshape(n_data, n_spatial),
                      mesh_dim_names=("data", "spatial"))


def placements(mesh: DeviceMesh, spec) -> list:
    """The DTensor placements of a JAX ``PartitionSpec``-like ``spec`` (per
    tensor dim a mesh dim name or None): each mesh dim named in ``spec``
    shards the tensor dim it names, every other mesh dim replicates."""
    spec = tuple(spec)
    return [Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh.mesh_dim_names]


def data_placements(mesh: DeviceMesh) -> list:
    """Batch data parallelism for NCHW tensors (JAX
    ``P("data", None, None, None)``): N over 'data'."""
    return placements(mesh, ("data", None, None, None))


def spatial_placements(mesh: DeviceMesh) -> list:
    """Batch and spatial tiles (JAX ``P("data", None, hx, "spatial")``): N
    over 'data', W over 'spatial', and H over 'spatial_h' on a 2-D
    tiling mesh."""
    hx = "spatial_h" if "spatial_h" in mesh.mesh_dim_names else None
    return placements(mesh, ("data", None, hx, "spatial"))


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, backend: str | None = None,
                         device_type: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` at ``coordinator_address``
    (``host:port``, or a full ``tcp://`` / ``file://`` init method) for
    rank ``process_id`` of ``num_processes``.  The backend defaults to
    'nccl' for ``device_type`` 'cuda' and 'gloo' for 'cpu'."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id)
