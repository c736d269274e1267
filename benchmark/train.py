"""The detection training cell: one `DetectionTrainer` (model and AdamW
state), driven from the seed's weights through its first three steps in
set-up, which the check follows, and then stepped back to back for the
window on the traffic's pool of batches, each step with sampler draws the
benchmark makes.  Batches travel as `DetectionTrainer.train` feeds them:
compact (uint8 image, bool masks and voxels) and already on the card.
A traffic with `ranks` > 1 trains data-parallel, one process per card
(`train_dp.py`)."""

from __future__ import annotations

import gc
import inspect
import shutil
import tempfile
import time

from benchmark import common
from benchmark import traffic as traffic_gen

CHECKED_STEPS = 3


def draws_for(gen, batch: int, anchors: int, rois: int, device, cls):
    """The sampler draws of one step: uniform [0, 1) per anchor and per ROI
    candidate (proposals, then GT slots) of each image."""
    import torch
    return cls(torch.rand((batch, anchors), generator=gen, device=device),
               torch.rand((batch, rois), generator=gen, device=device))


def draw_shapes(conf: dict) -> tuple:
    """(anchors, ROI candidates) per image, from the reference's detector
    built on the meta device."""
    _, cfg, det, _ = common.meta_models(conf)
    return (det.anchors.shape[0],
            det.num_proposals_train() + cfg.detection.max_instances)


def device_pool(host: list, dev) -> list:
    """The traffic's batches as the program's `DetectionSample`s on
    `dev`."""
    import torch

    from mot3d_tpu_torch.data.detection_loader import DetectionSample
    return [DetectionSample(**{f: (torch.from_numpy(b[f]).to(dev)
                                   if f in b else None)
                               for f in DetectionSample._fields})
            for b in host]


def make_trainer(cfg, scratch: str, device, params: dict, mesh=None):
    """The program's `DetectionTrainer` with its model and AdamW state, on
    the given weights.  On a data mesh (`parallel/mesh.py:DataMesh`) every
    rank starts from rank 0's weights and averages the ranks' gradients
    before each AdamW step with the program's `replicate` and
    `all_mean_grads`, as the program's mesh steps do between their
    backward pass and their update; a trainer that takes `mesh=` is given
    the mesh instead and does both itself."""
    from mot3d_tpu_torch.parallel import mesh as meshes
    from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
    if mesh is not None and \
            "mesh" in inspect.signature(DetectionTrainer).parameters:
        trainer = DetectionTrainer(cfg, scratch, device=device, mesh=mesh)
        trainer.init_state(params=params)
        return trainer
    trainer = DetectionTrainer(cfg, scratch, device=device)
    trainer.init_state(params=params)
    if mesh is not None:
        meshes.replicate(mesh, trainer.model)
        grads = list(trainer.model.parameters())
        trainer.state.optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: meshes.all_mean_grads(mesh, grads))
    return trainer


def checked_steps(step, model, opt) -> dict:
    """Set-up: the first CHECKED_STEPS steps (`step(k)` -> (losses,
    draws)), which the check follows; they warm every shape.  Keeps each
    step's losses and draws, the proposals the program selected (the
    reference takes them: see `reference_steps`) and, after the first
    step, the norms of the gradients AdamW was given."""
    from benchmark import compare
    from mot3d_tpu_torch.models import mask_rcnn as prog_rcnn
    prog = {"losses": [], "draws": [], "proposals": []}
    select = prog_rcnn.select_proposals

    def kept_proposals(*args, **kwargs):
        out = select(*args, **kwargs)
        prog["proposals"].append(tuple(x.detach().clone() for x in out))
        return out
    prog_rcnn.select_proposals = kept_proposals
    try:
        for k in range(CHECKED_STEPS):
            losses, draws = step(k)
            prog["draws"].append(tuple(x.clone() for x in draws))
            prog["losses"].append({n: float(v) for n, v in losses.items()})
            if k == 0:
                prog["grads"] = compare.first_grads(model, opt)
    finally:
        prog_rcnn.select_proposals = select
    return prog


def run(c: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float = 0.0) -> dict:
    if c["traffic"].get("ranks", 1) > 1:
        from benchmark import train_dp
        return train_dp.run(c, seed, seconds, trace, device, t_process)
    import torch

    from benchmark import compare
    from benchmark import profiling as tr
    from mot3d_tpu_torch.models.mask_rcnn import DetectionDraws

    conf, traf = c["config"], c["traffic"]
    data = conf["config"]
    cfg = common.program_config(data)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    scratch = tempfile.mkdtemp(prefix="bench-train-")
    w_det, _ = common.model_weights(conf, seed, dev)
    start_params = {k: v.clone() for k, v in w_det.items()}
    trainer = make_trainer(cfg, scratch, dev, w_det)
    del w_det
    host = traffic_gen.detection_batches(seed, traf, data)
    pool = device_pool(host, dev)
    b = traf["batch"]
    anchors, rois = draw_shapes(conf)
    gen = torch.Generator(device=dev).manual_seed(seed % (2 ** 63))

    def step(k):
        draws = draws_for(gen, b, anchors, rois, dev, DetectionDraws)
        return trainer.train_step(pool[k % len(pool)], draws), draws

    model, opt = trainer.model, trainer.state.optimizer
    prog = checked_steps(step, model, opt)
    kept_draws, proposals = prog.pop("draws"), prog["proposals"]
    prog["changes"] = compare.changes(model, start_params)
    del start_params
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    prof = tr.Profile(("step",)) if trace else None
    tw = traf["trace_window"]
    if trace:
        tr.Profile.warm(dev)
    start = time.perf_counter()
    end = start + seconds
    # A traced run profiles tw["profile_seconds"] of steps from t_prof;
    # its rate is read before that.
    t_prof = start + tw["profile_from"] * seconds
    setup_s = start - t_process
    k, steps, plain_rate = CHECKED_STEPS, 0, None
    while time.perf_counter() < end:
        if trace and prof.prof is None and time.perf_counter() >= t_prof:
            prof.start()            # synchronises first
            plain_rate = steps / (prof.t0 - start)
        with tr.label("step", trace and prof.on):
            step(k)
        k += 1
        steps += 1
        if trace and prof.on:
            prof.calls += 1
            if time.perf_counter() >= prof.t0 + tw["profile_seconds"]:
                prof.stop()
    if trace and prof.on:
        prof.stop()
    sync()
    window = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = prof.summary() if trace else None

    # Free the program, then follow its first steps with the reference.
    t_check = time.perf_counter()
    del trainer, model, opt, pool, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(scratch, ignore_errors=True)
    ref = reference_steps(conf, seed, host, kept_draws, proposals, dev)
    readings = compare.train_readings(prog, ref)
    readings["check_s"] = time.perf_counter() - t_check
    return {"setup_s": setup_s, "window_s": window, "steps": steps,
            "attempted": steps, "images": steps * b,
            "train_images_per_s": steps * b / window,
            "memory_peak_bytes": peak, "trace": summary,
            "plain_rate": plain_rate,
            "readings": readings}


def reference_steps(conf: dict, seed: int, host: list, draws: list,
                    proposals: list, dev, ranks: int = 1) -> dict:
    """The reference's first steps from the same weights, batches and
    draws, in float32 with TF32 off.  Each forward takes the proposals the
    program selected in it and keeps its own beside them: the selection
    (top-k and NMS on the RPN's scores) turns the last digits of the
    scores into different proposal sets, and the ROI losses then differ by
    the sampling and not by the arithmetic.  With `ranks` > 1, `host[k]`
    and `draws[k]` list every rank's batch and draws of step k, each step
    is the reference's data-parallel step (`reference/dp_steps.py`), and
    `proposals` follow step by step in rank order."""
    import torch

    from benchmark import compare
    from benchmark.reference import dp_steps, steps

    refs, cfg, det, _ = common.reference_models(conf, dev)
    w_det, _ = common.model_weights(conf, seed, dev)
    det.load_state_dict(w_det)
    opt, sched = steps.detection_optimizer(cfg, det)
    select = refs.proposals.select_proposals
    own, given = [], iter(proposals)

    def program_proposals(*args, **kwargs):
        mine = select(*args, **kwargs)
        own.append(tuple(x.detach() for x in mine))
        theirs = next(given, None)
        if theirs is None or theirs[0].shape != mine[0].shape:
            return mine
        return theirs
    refs.proposals.select_proposals = program_proposals
    out = {"losses": []}
    try:
        with steps.true_fp32():
            for k, d in enumerate(draws):
                if ranks > 1:
                    out["losses"].append(dp_steps.train_step(
                        det, opt, sched, host[k],
                        [refs.detector.DetectionDraws(*x) for x in d], dev))
                else:
                    out["losses"].append(steps.train_step(
                        det, opt, sched, host[k],
                        refs.detector.DetectionDraws(*d), dev))
                if k == 0:
                    out["grads"] = compare.leaf_norms(
                        {n: p.grad for n, p in det.named_parameters()})
    finally:
        refs.proposals.select_proposals = select
    out["changes"] = compare.changes(det, w_det)
    out["proposals"] = own
    del det, opt, w_det
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
