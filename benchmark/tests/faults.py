"""Faults and controls planted under the timed path, for the tests and the
calibration that show the check fails them.  `install(name, target)`
breaks the serving step or the trainer in place; `serving_client` and
`trainer_maker` plant one where a run builds its step or its trainer, so
that a whole run goes through the broken path; `training_rank` plants one
in each job of a data-parallel rank.

The control `bfloat16` puts the detector in bfloat16, the program's own
path (`detection.compute_dtype`)."""

from __future__ import annotations

import dataclasses

import torch

SERVE = ("detector_answer", "slot_heads", "pose_answer", "edge_answer")
TRAIN = ("half_batch", "state_unchanged")
# A data-parallel cell can have these too: the exchange left out (each rank
# steps on its own gradients), one rank that does not divide the sum, every
# rank that does not, and one rank trained on another rank's batch.
TRAIN_DP = TRAIN + ("no_exchange", "no_mean_one_rank", "grads_summed",
                    "shard_duplicated")


def _alter_stage(step, stage, edit):
    fn = getattr(step, stage)

    def broken(*args, **kwargs):
        return edit(fn(*args, **kwargs))
    setattr(step, stage, broken)


def _bump(t: torch.Tensor, by: float) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[0] += by
    return t


def _other_slot(t: torch.Tensor, dst: int = 1, src: int = 2):
    """(T, I, ...) with slot `dst` of every frame given slot `src`'s
    values: one detection's heads read from its neighbour's ROI."""
    t = t.clone()
    t[:, dst] = t[:, src]
    return t


def _scale_grads(trainer, by: float) -> None:
    """The trainer's gradients multiplied by `by` just before each AdamW
    step, after the ranks' exchange."""
    params = list(trainer.model.parameters())

    def scale(opt, args, kwargs):
        for p in params:
            p.grad.mul_(by)
    trainer.state.optimizer.register_step_pre_hook(scale)


def install(name: str, target, mesh=None) -> None:
    if name == "detector_answer":       # every score altered by 0.001
        _alter_stage(target, "detect",
                     lambda d: d._replace(scores=d.scores + 1e-3))
    elif name == "slot_heads":          # one slot's heads from another ROI
        _alter_stage(target, "detect", lambda d: d._replace(
            masks=_other_slot(d.masks), nocs=_other_slot(d.nocs),
            voxels=_other_slot(d.voxels)))
    elif name == "pose_answer":         # one pose's translation altered
        _alter_stage(target, "pose", lambda f: f._replace(
            translations=_bump(f.translations, 0.05)))
    elif name == "edge_answer":         # one edge probability altered
        _alter_stage(target, "track",
                     lambda r: (_bump(r[0], 0.05), r[1]))
    elif name == "state_unchanged":     # the update leaves the weights
        opt = target.state.optimizer
        opt.step = lambda *a, **k: None
    elif name == "half_batch":          # half the batch, mean over the rest
        model = target.model
        losses = model.train_losses

        def half(images, gt, draws, feats=None):
            h = images.shape[0] // 2
            return losses(images[:h], type(gt)(*(x[:h] for x in gt)),
                          type(draws)(*(x[:h] for x in draws)))
        model.train_losses = half
    elif name == "grads_summed":        # the ranks' sum, not their mean
        _scale_grads(target, mesh.size)
    elif name == "no_mean_one_rank":    # rank 1 keeps the sum
        if mesh.rank == 1:
            _scale_grads(target, mesh.size)
    else:
        raise ValueError(f"unknown fault {name!r}")


def bf16_cell(c: dict) -> dict:
    """The cell with the program's detector in bfloat16 (the reference
    keeps the configuration as stated: build it from the original)."""
    data = {**c["config"]["config"]}
    data["detection"] = {**data["detection"], "compute_dtype": "bfloat16"}
    return {**c, "config": {**c["config"], "config": data}}


def build_step(name: str, c: dict, seed: int, dev, make=None):
    """The serving step of the cell (built by `make`, by default
    `serve.make_step`) with `name` planted ("" for none)."""
    from benchmark import serve
    make = make or serve.make_step
    if name == "bfloat16":
        return make(bf16_cell(c), seed, dev)
    step = make(c, seed, dev)
    if name:
        install(name, step)
    return step


def serving_client(name: str, *args):
    """`serve.client_main` with `name` planted in the step it builds: the
    target of a spawned client (`functools.partial(serving_client, name)`
    in place of `serve.client_main`), patched in the client's own
    process."""
    from benchmark import serve
    make = serve.make_step
    serve.make_step = lambda c, seed, dev: build_step(name, c, seed, dev,
                                                      make)
    serve.client_main(*args)


def trainer_maker(name: str):
    """A `train.make_trainer` that builds the trainer with `name`
    planted."""
    from benchmark import train
    make = train.make_trainer

    def planted(cfg, scratch, device, params, mesh=None):
        if name == "bfloat16":
            cfg = dataclasses.replace(cfg, detection=dataclasses.replace(
                cfg.detection, compute_dtype="bfloat16"))
            return make(cfg, scratch, device, params, mesh)
        if name == "no_exchange":
            return make(cfg, scratch, device, params)
        trainer = make(cfg, scratch, device, params, mesh)
        if name != "shard_duplicated":
            install(name, trainer, mesh)
        return trainer
    return planted


def training_rank(plants: list, *args):
    """`train_dp.rank_main` with job i's fault or control `plants[i]` ("" for
    none) planted in this rank's process while that job runs: the target
    of the spawned ranks (`functools.partial(training_rank, plants)` in
    place of `train_dp.rank_main`).  "shard_duplicated" gives rank 1 the
    batch rank 0 trains on."""
    from benchmark import train, train_dp
    job, make, index = train_dp.rank_job, train.make_trainer, \
        train_dp.batch_index
    todo = iter(plants)

    def duplicated(step, rank, ranks, pool):
        return index(step, 0 if rank == 1 else rank, ranks, pool)

    def planted_job(*a, **k):
        plant = next(todo)
        train.make_trainer = trainer_maker(plant) if plant else make
        if plant == "shard_duplicated":
            train_dp.batch_index = duplicated
        try:
            return job(*a, **k)
        finally:
            train.make_trainer, train_dp.batch_index = make, index
    train_dp.rank_job = planted_job
    train_dp.rank_main(*args)
