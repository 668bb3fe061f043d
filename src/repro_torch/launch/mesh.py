"""Production meshes for H100 clusters, the port's `repro.launch.mesh`.

  single : (data=32, model=8)          = 256 cards
  multi  : (pod=2, data=32, model=8)   = 512 cards; `pod` is the FL
           island axis (one island a pod, the paper's semantics).

`model = 8` is the NVLink domain of one 8-GPU H100 node, so tensor
parallelism never crosses a node (dist/hardware.py charges the "model"
axis at NVLink's bandwidth, "data" and "pod" at the network's).  256 and
512 cards are the reference's 256 and 512 chips, so every `SHAPES` global
batch divides as it does there.

The analytic layer (dist/policy.py, launch/dryrun.py) reads only a mesh's
axis names and sizes: `abstract_production_mesh` and `make_host_mesh`
give `AbstractMesh`es and need no process group; the host mesh is the
one device this process places tensors on.  `make_mesh` /
`make_production_mesh` build a `torch.distributed` DeviceMesh, and only
when `torch.distributed` is initialised with that world size; otherwise
they raise.
"""
from __future__ import annotations

import math

from repro_torch.dist.sharding import AbstractMesh, mesh_sizes


def production_mesh_spec(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh, without touching devices."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def make_mesh(shape, axes, *, device_type: str | None = None):
    """A DeviceMesh of `shape` over `axes` across the ranks of the
    initialised process group, whose world size must equal the mesh's
    size (give `init_process_group` its address, world size and rank)."""
    import torch
    import torch.distributed as dist
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh{tuple(shape)}: torch.distributed is not initialised "
            f"(a mesh of {n} devices needs a process group of world size "
            f"{n}); the analytic layer takes an AbstractMesh instead")
    if dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh{tuple(shape)}: world size "
                           f"{dist.get_world_size()} != {n} devices")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = production_mesh_spec(multi_pod=multi_pod)
    return make_mesh(shape, axes)


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes, for ANALYTIC layout
    checks, without 512 devices."""
    shape, axes = production_mesh_spec(multi_pod=multi_pod)
    return AbstractMesh(shape, axes)


def make_host_mesh() -> AbstractMesh:
    """The devices this process places tensors on, as a (1, 1) mesh over
    ("data", "model").  The port runs one process on one device and
    shards nothing, so a host with 4 or 8 cards is still one card here:
    a (1, n) mesh would let the policy divide params and cache by n that
    all sit on the one card.  One process needs no process group."""
    return AbstractMesh((1, 1), ("data", "model"))


def n_islands(mesh) -> int:
    return mesh_sizes(mesh).get("pod", 1)
