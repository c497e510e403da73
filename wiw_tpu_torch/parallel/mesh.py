"""The (dp, fsdp) device mesh and its sharding rules on torch.distributed.

Port of `wiw_tpu/parallel/mesh.py`. Axes:
  dp    data parallelism: the batch is split, gradients are averaged
  fsdp  parameter and optimizer-state sharding (FSDP2's `fully_shard`):
        every UNet unit holds its shard of each parameter, gathers the
        full parameters for its forward and backward and reduce-scatters
        its gradients; the batch is split over it too
A 2-D mesh is FSDP2's hybrid form: parameters sharded over 'fsdp' and
replicated over 'dp'. The reference's rule for a leaf's shard axis
(`leaf_axis`) is a pure function of its shape in the reference's (flax)
layout; `shard_unet` maps it onto the port's layout.

One departure: FSDP2 shards every parameter of a unit, so a leaf the
reference keeps whole (fewer than 2^16 elements, or no axis divisible by
the fsdp size) is split along its first axis, unevenly where it must be.
That changes where the values live, not what they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from wiw_tpu_torch.models.convert import flax_axes, translate_key

# leaves smaller than this the reference keeps whole
MIN_SHARD_ELEMS = 2**16


def make_mesh(dp: Optional[int] = None, fsdp: int = 1) -> DeviceMesh:
    """A ('dp', 'fsdp') mesh over every rank of the process group, on its
    backend's device type (NCCL: cuda, gloo: cpu)."""
    n = dist.get_world_size()
    if dp is None:
        dp = n // fsdp
    if dp * fsdp != n:
        raise ValueError(f"dp({dp}) * fsdp({fsdp}) != devices({n})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, fsdp), mesh_dim_names=("dp", "fsdp"))


def leaf_axis(shape, fsdp_size: int) -> Optional[int]:
    """The reference's rule (`_leaf_spec`): the largest axis divisible by
    the fsdp size, the later one on ties, or None (the leaf stays whole)
    for a leaf of fewer than MIN_SHARD_ELEMS elements or without such an
    axis. `shape` is in the reference's layout."""
    if fsdp_size <= 1 or np.prod(shape, dtype=np.int64) < MIN_SHARD_ELEMS:
        return None
    best_axis, best_size = None, 0
    for i, s in enumerate(shape):
        if s % fsdp_size == 0 and s >= best_size:
            best_axis, best_size = i, s
    return best_axis


def batch_rows(mesh: DeviceMesh, rank: int, global_batch: int) -> range:
    """The rows of a global batch that `rank` holds: the batch split over
    every device of the mesh, dp-major then fsdp, as the reference's
    P(("dp", "fsdp")) splits it."""
    n = mesh.size()
    if global_batch % n:
        raise ValueError(f"batch {global_batch} must be a multiple of the "
                         f"mesh size {n}")
    pos = mesh.mesh.flatten().tolist().index(rank)
    per = global_batch // n
    return range(pos * per, (pos + 1) * per)


def gather_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows `x`, on every rank: the
    inverse of `batch_rows`, the rows in the order of the mesh's
    positions."""
    n = dist.get_world_size()
    parts = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(parts, x.contiguous())
    parts = parts.chunk(n)
    return torch.cat([parts[r] for r in mesh.mesh.flatten().tolist()])


def shard_unet(unet: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Shard the UNet's parameters over 'fsdp' (replicated over 'dp') with
    FSDP2: every ResBlock, transformer and resampler of its levels is a
    unit of its own (the UNet calls them, not the levels' modules, whose
    forward FSDP2 would hook), then the UNet holds the rest. Each
    parameter is split along the axis the reference's rule gives its flax
    leaf, mapped to the port's layout."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    fsdp = mesh["fsdp"].size()
    placement = {}
    for name, p in unet.named_parameters():
        path = translate_key(name)
        axes = flax_axes(path, p.ndim)
        axis = leaf_axis([p.shape[a] for a in axes], fsdp)
        if axis is not None:
            placement[p] = Shard(axes[axis])

    def place(p):
        return placement.get(p)  # None: FSDP2's default, the first axis

    for block in (*unet.down_blocks, unet.mid_block, *unet.up_blocks):
        for units in block.children():
            for unit in units:
                fully_shard(unit, mesh=mesh, shard_placement_fn=place)
    fully_shard(unet, mesh=mesh, shard_placement_fn=place)
    return unet
