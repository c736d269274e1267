"""Multi-process rendezvous (counterpart of `mot3d_tpu/parallel/multihost.py`).

The reference scales out with detectron2's `launch(num_machines,
machine_rank, dist_url)` over torch.distributed
(`Detection/train_net.py:194-201`); the JAX package replaces it with
`jax.distributed.initialize`.  Here it is torch.distributed again:

  - `maybe_initialize_distributed` — `torch.distributed.init_process_group`
    guarded by the JAX package's env vars (MOT3D_COORDINATOR = host:port,
    MOT3D_NUM_PROCESSES, MOT3D_PROCESS_ID); explicit arguments win.  A
    no-op unless at least two processes are configured, so a one-process
    workflow never pays for it.
  - `make_global_mesh` — the `data` mesh over every rank.
  - `host_local_batch_to_global` — per-rank feeding: every rank loads its
    own rows of the global batch and keeps them (there is no global array
    in torch: the steps reduce gradients, not arrays).
  - `replicate_global` — parameters made equal on every rank.
  - `is_main_process` — rank-0 gating for writers and checkpoints.

Design difference: a JAX process is a host that owns several chips, a
torch process owns one GPU.  MOT3D_NUM_PROCESSES therefore counts ranks.
At the rendezvous every rank posts its host name and card count to the
coordinator's store and reads everyone's (`placements`); a rank takes the
card of its index among the ranks of its own host (`local_index`, modulo
the host's cards) through `torch.cuda.set_device`, so that
`resolve_device(None)` is that rank's card.  With one host, or hosts that
hold consecutive ranks, that is `cuda:(r % cards)`.

Backend rule, fixed from the placements before the group is made
(`backend_for`, the same answer on every rank) and named on the mesh:
NCCL when every rank runs on CUDA and no host holds more ranks than cards;
gloo on the CPU and when ranks share a card, since NCCL refuses two ranks
on one device.  It is decided per host, so 2 hosts x 4 cards at world
size 8 reduce over NCCL.
"""

from __future__ import annotations

import collections
import datetime
import os
import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.parallel.mesh import DataMesh, make_mesh, replicate

ENV_COORDINATOR = "MOT3D_COORDINATOR"
ENV_NUM_PROCESSES = "MOT3D_NUM_PROCESSES"
ENV_PROCESS_ID = "MOT3D_PROCESS_ID"

# How long a rank waits for the others, at the rendezvous and in every
# collective, before it raises instead of hanging.
TIMEOUT = datetime.timedelta(seconds=600)


def placements(store, world_size: int, rank: int,
               cards: int) -> List[Tuple[str, int]]:
    """Every rank's (host name, card count), in rank order, exchanged
    through the rendezvous store; `cards` is 0 for a rank on the CPU."""
    store.set(f"mot3d/placement/{rank}", f"{socket.gethostname()}\t{cards}")
    out = []
    for r in range(world_size):
        host, n = store.get(f"mot3d/placement/{r}").decode().split("\t")
        out.append((host, int(n)))
    return out


def local_index(places: List[Tuple[str, int]], rank: int) -> int:
    """`rank`'s index among the ranks on its own host."""
    host = places[rank][0]
    return sum(h == host for h, _ in places[:rank])


def backend_for(places: List[Tuple[str, int]]) -> str:
    """"nccl" when every rank runs on CUDA and no host holds more ranks
    than cards, else "gloo"."""
    ranks = collections.Counter(h for h, _ in places)
    if all(n > 0 and ranks[h] <= n for h, n in places):
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str, world_size: int, rank: int,
                     device=None) -> torch.device:
    """Join the process group at `coordinator` (host:port) as `rank` of
    `world_size` and return this rank's device: on CUDA (the default) the
    rank's own card on its host, made current."""
    dev = resolve_device(device)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host.strip("[]"), int(port), world_size,
                          is_master=rank == 0, timeout=TIMEOUT)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    places = placements(store, world_size, rank, cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_index(places, rank) % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(places), store=store,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return dev


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device=None) -> bool:
    """Initialise torch.distributed iff a multi-process run is configured.

    Explicit arguments win; otherwise the MOT3D_* env vars are read (so
    the same CLI entry point works alone and across processes, as the
    reference's `launch()` wraps both).  `device=None` means each rank's
    GPU.  Returns True iff a process group exists (made now or earlier)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "0") or 0)
    if process_id is None:
        pid = os.environ.get(ENV_PROCESS_ID)
        process_id = int(pid) if pid is not None else None
    if not coordinator or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError(f"{ENV_COORDINATOR} and {ENV_NUM_PROCESSES} are "
                         f"set but not {ENV_PROCESS_ID}: each process needs "
                         "its rank")
    init_distributed(coordinator, num_processes, process_id, device)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def make_global_mesh(axis: str = "data", device=None) -> DataMesh:
    """The 1-D mesh over every rank of the process group (one process, no
    group: a mesh of one)."""
    return make_mesh(0, axis, device)


def host_local_batch_to_global(mesh: DataMesh, tree):
    """This rank's rows of the global batch, as tensors on its device.
    Every leaf's leading axis is the LOCAL batch; the global batch is
    local batch * mesh.size.  Unlike `shard_batch` nothing is sliced: the
    rank loaded only its own rows."""
    return mesh.to_device(tree)


def replicate_global(mesh: DataMesh, tree):
    """Rank 0's values on every rank (`mesh.replicate`); every rank must
    hold tensors of the same shapes."""
    return replicate(mesh, tree)


def global_batch_size(local_batch_size: int) -> int:
    size = dist.get_world_size() if dist.is_initialized() else 1
    return local_batch_size * size

