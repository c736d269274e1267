"""One rank of the port's data-parallel CPU test
(tests/test_torch_port_parallel.py), started by `subprocess`.

It joins the gloo group through the MOT3D_* env-var rendezvous
(`maybe_initialize_distributed`), then runs on its rows of each global
batch: the tracking step (SGD at LR 1, float64), the combined step in its
three modes (draws from a seeded generator), and the sharded serving
step.  Inputs come from the parent's `inputs.pt` (`torch_port_helpers.
start_ranks`); the rank's results go to `rank<r>.pt`.  On CUDA the rank
takes its card (`multihost.init_distributed`) and runs under
deterministic algorithms.  The worker imports no JAX.

Usage: python _torch_parallel_worker.py <rank> <nproc> <port> <dir> [device]
"""

import copy
import os
import sys

import torch

rank, nproc, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
os.environ["MOT3D_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["MOT3D_NUM_PROCESSES"] = str(nproc)
os.environ["MOT3D_PROCESS_ID"] = str(rank)
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from mot3d_tpu_torch.parallel import multihost  # noqa: E402
from mot3d_tpu_torch.parallel.infer_step import (  # noqa: E402
    SequenceBatch, make_sequence_infer_step)
from mot3d_tpu_torch.parallel.mesh import replicate, shard_batch  # noqa
from mot3d_tpu_torch.parallel.train_step import (  # noqa: E402
    CombinedBatch, CombinedTrainState, TrackingBatch, TrackingTrainState,
    make_combined_train_step, make_tracking_train_step)
from mot3d_tpu_torch.train.combined_trainer import (  # noqa: E402
    detection_optimizer, tracking_optimizer)

if device != "cpu":
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
initialised = multihost.maybe_initialize_distributed(device=device)
mesh = multihost.make_global_mesh(device=device)
# The parent wrote this file for this run: it holds configs and tensors.
inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
out = {"initialised": initialised, "rank": mesh.rank, "size": mesh.size,
       "backend": mesh.backend, "main": multihost.is_main_process(),
       "global_batch": multihost.global_batch_size(2),
       "replicated": multihost.replicate_global(
           mesh, {"w": torch.full((3,), float(rank))})["w"].cpu()}


def sgd(model):
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1.0)


# The tracking step, SGD at LR 1: the new parameters are the old ones
# minus the mean gradient of the global batch.
tr = inp["tracking"]
model = replicate(mesh, copy.deepcopy(tr["model"]).to(mesh.device))
state = TrackingTrainState(model, *sgd(model))
step = make_tracking_train_step(model, tr["template"], tr["cfg"],
                                mesh=mesh)
batch = multihost.host_local_batch_to_global(
    mesh, shard_batch(mesh, TrackingBatch(**tr["batch"])))
state, metrics = step(state, batch)
out["tracking"] = {"loss": metrics["tracking_loss"].cpu(),
                   "step": state.step,
                   "params": {n: p.detach().cpu()
                              for n, p in model.named_parameters()}}

# The combined step in its three modes.
co = inp["combined"]
out["combined"] = {}
for mode, kw in co["modes"].items():
    det = replicate(mesh, copy.deepcopy(co["det"]).to(mesh.device))
    trk = replicate(mesh, copy.deepcopy(co["trk"]).to(mesh.device))
    cfg = co["cfg"]
    state = CombinedTrainState(det, *detection_optimizer(cfg, det), trk,
                               *tracking_optimizer(cfg, trk))
    step = make_combined_train_step(det, trk, co["template"], cfg,
                                    remat=False, mesh=mesh, **kw)
    gen = torch.Generator(mesh.device).manual_seed(co["seed"])
    state, metrics = step(state, shard_batch(
        mesh, CombinedBatch(**co["batch"])), generator=gen)
    out["combined"][mode] = {
        "metrics": {k: v.cpu() for k, v in metrics.items()},
        "step": state.step,
        "grads": [{n: p.grad.cpu() for n, p in m.named_parameters()}
                  for m in (det, trk)],
        "params": [{n: p.detach().cpu() for n, p in m.named_parameters()}
                   for m in (det, trk)]}

# Sharded serving: this rank's sequences, the outputs of all.
sv = inp["serving"]
step = make_sequence_infer_step(replicate(mesh, sv["det"].to(mesh.device)),
                                replicate(mesh, sv["trk"].to(mesh.device)),
                                sv["template"], sv["cfg"], mesh=mesh)
gen = torch.Generator(mesh.device).manual_seed(sv["seed"])
out["serving"] = {k: v.cpu() for k, v in step(
    shard_batch(mesh, SequenceBatch(**sv["batch"])),
    generator=gen)._asdict().items()}

torch.save(out, os.path.join(work, f"rank{rank}.pt"))
dist.destroy_process_group()
