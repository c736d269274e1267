"""The data mesh and its collectives (counterpart of
`mot3d_tpu/parallel/mesh.py`).

The reference trains data-parallel through detectron2's `launch()` and
torch.distributed over NCCL (`Detection/train_net.py:194-201`).  The JAX
package shards batches over a 1-D `data` mesh and lets XLA insert the
gradient psum; here the mesh is the process group, one rank per GPU, and
the reductions are explicit:

  - `shard_batch` keeps this rank's rows of a batch's leading axis (the
    `P("data")` layout: the batch must divide by the world size);
  - `replicate` makes every rank hold rank 0's parameters and buffers;
  - `all_mean_grads` averages one model's gradients: one flat buffer,
    one all_reduce, one division by the world size;
  - `all_mean` averages a dict of metrics in one all_reduce;
  - `gather_batch` concatenates every rank's rows on the leading axis (in
    place of JAX's global array).

The steps' losses are means over their windows or sequences, so with
equal shards the mean of the ranks' means is the mean over the global
batch.  gloo moves CUDA tensors through the host: the collectives copy
them there and back themselves (gloo's own CUDA support covers only some
of them).  Without a process group the mesh is one rank and every
collective is skipped; with one, even of size 1, they run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.utils.tree import as_tensor, tree_map


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D `data` mesh: this rank, the world and the process group."""

    group: Optional[dist.ProcessGroup]  # None: one process, no group
    rank: int
    size: int
    device: torch.device                # this rank's device
    backend: Optional[str]              # "nccl" or "gloo"; None: no group
    axis: str = "data"

    def to_device(self, tree):
        """Every leaf of `tree` as a tensor on this rank's device."""
        return tree_map(lambda x: as_tensor(x).to(self.device), tree)


def make_mesh(num_devices: int = 0, axis: str = "data",
              device=None) -> DataMesh:
    """The mesh over every rank of the default process group, or a mesh of
    one without a group.  `num_devices` is 0 (all) or the world size: a
    torch rank cannot leave part of its group out of a collective.
    `device=None` means this rank's GPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend()).lower()
    else:
        group, rank, size, backend = None, 0, 1, None
    if num_devices not in (0, size):
        raise ValueError(f"make_mesh({num_devices}): the mesh spans the "
                         f"whole process group of {size}; pass 0 or {size}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group reduces CUDA tensors; got {dev}")
    return DataMesh(group, rank, size, dev, backend, axis)


def mesh_device(device, mesh: Optional[DataMesh]) -> torch.device:
    """An entry point's device: `resolve_device(device)` without a mesh,
    the mesh's device with one (`device` may only name it again)."""
    if mesh is None:
        return resolve_device(device)
    want = torch.device(device) if device is not None else mesh.device
    if want.type != mesh.device.type or want.index not in (
            None, mesh.device.index):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def shard_batch(mesh: DataMesh, tree):
    """This rank's rows of every leaf's leading (batch) axis."""
    def rows(x):
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not divide over the "
                             f"{mesh.size} ranks of the `{mesh.axis}` mesh")
        n = b // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n]
    return tree_map(rows, tree)


def _wire(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: on the host for gloo, bool as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.cpu() if mesh.backend == "gloo" else x.contiguous()


def _all_reduce_(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks, in place."""
    wire = _wire(mesh, x)
    dist.all_reduce(wire, group=mesh.group)
    if wire is not x:
        x.copy_(wire)
    return x


def _broadcast_(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0's `x` on every rank, in place."""
    wire = _wire(mesh, x)
    dist.broadcast(wire, src=0, group=mesh.group)
    if wire is not x:
        x.copy_(wire)
    return x


def _flat(tensors: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: list) -> None:
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def replicate(mesh: DataMesh, module_or_tree):
    """Rank 0's values on every rank: a module's parameters and buffers in
    place (one broadcast per dtype), or a tree's leaves as tensors on this
    rank's device."""
    if isinstance(module_or_tree, torch.nn.Module):
        if mesh.group is not None:
            tensors = [t.data for t in module_or_tree.parameters()] + \
                list(module_or_tree.buffers())
            for dtype in dict.fromkeys(t.dtype for t in tensors):
                same = [t for t in tensors if t.dtype == dtype]
                flat = _broadcast_(mesh, _flat(same))
                _unflat_(flat, same)
        return module_or_tree
    tree = mesh.to_device(module_or_tree)
    if mesh.group is not None:
        tree = tree_map(lambda x: _broadcast_(mesh, x.clone()), tree)
    return tree


def all_mean_grads(mesh: DataMesh, params: Iterable[torch.Tensor]) -> None:
    """Average one model's gradients over the ranks, in place: one flat
    buffer, one all_reduce, one division.  Every parameter needs a
    gradient (`train_step._zero_missing_grads`), so that every rank sends
    the same tensors in the same order."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise ValueError("all_mean_grads: a parameter has no gradient")
    flat = _all_reduce_(mesh, _flat(grads))
    flat /= mesh.size
    _unflat_(flat, grads)


def all_mean(mesh: DataMesh, metrics: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """The metrics averaged over the ranks, in one all_reduce."""
    if mesh.group is None or not metrics:
        return metrics
    names = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().to(
        mesh.device, torch.float64) for k in names])
    vals = dict(zip(names, _all_reduce_(mesh, vals) / mesh.size))
    return {k: vals[k].to(torch.as_tensor(v).dtype)
            for k, v in metrics.items()}


def gather_batch(mesh: DataMesh, tree):
    """Every rank's rows, concatenated on the leading axis in rank order,
    on every rank (the shards must have equal shapes)."""
    if mesh.group is None:
        return tree

    def gather(x):
        x = as_tensor(x)
        wire = _wire(mesh, x)
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire, group=mesh.group)
        return torch.cat(parts).to(x.device, x.dtype)
    return tree_map(gather, tree)
