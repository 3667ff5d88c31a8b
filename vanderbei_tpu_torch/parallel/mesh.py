"""Device mesh construction, the port of vanderbei_tpu/parallel/mesh.py.

The scale-out axes are the JAX package's:

- "batch": data parallelism over LP instances (a size class's lanes split
  over the ranks of a "model" row),
- "model": tensor parallelism within one large LP, A's columns split over
  the ranks (parallel/distributed.py).

Here a mesh is a torch DeviceMesh over the ranks of an initialised
process group, rank r at the place where the JAX grid puts device r
(row-major).  Each rank runs the same program (SPMD) on its own block.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("batch", "model") mesh of shape (n_devices // model_parallel,
    model_parallel) over the ranks of the default process group, which must
    be initialised and hold exactly n_devices ranks (by default: all)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by model_parallel="
            f"{model_parallel}")
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks")
    return init_device_mesh(device_type,
                            (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=("batch", "model"))


def block(mesh: DeviceMesh, t, axis: str, dim: int):
    """This rank's share of t's dim `dim` (a tensor or a numpy array, as a
    view): equal contiguous blocks over the mesh's `axis` ("batch" or
    "model"), in rank order."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    pos = mesh.get_local_rank(axis)
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} ({t.shape[dim]}) does not split over "
                         f"{size} {axis!r} ranks")
    width = t.shape[dim] // size
    index = [slice(None)] * t.ndim
    index[dim] = slice(pos * width, (pos + 1) * width)
    return t[tuple(index)]


def batch_sharding(mesh: DeviceMesh, t, dim: int = 0):
    """This rank's block of t's "batch" dim: the lanes split into equal
    contiguous blocks over the mesh's rows, in row order."""
    return block(mesh, t, "batch", dim)


def replicated(mesh: DeviceMesh, t):
    """t as the mesh's first rank holds it, on every rank of the mesh (a
    broadcast; t must have the same shape and dtype everywhere)."""
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return t
