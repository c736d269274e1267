"""The data-parallel detection training step of the reference, written out
plainly: what `DetectionTrainer` on a data mesh computes, one rank's batch
after another on one device, without the ranks and their exchange."""

from __future__ import annotations

import torch

from benchmark.reference.steps import _t, ground_truth


def train_step(det, opt, sched, batches: list, draws: list, device) -> dict:
    """One step over the ranks' batches: for each rank's batch and sampler
    draws the sum of the `loss*` terms and its gradients, the gradients
    summed over the ranks and divided by their number (a parameter without
    one counts as zero), then one AdamW update.  Returns each term's mean
    over the ranks (float) and "total"."""
    det.train()
    opt.zero_grad(set_to_none=True)
    per_rank = []
    for batch, d in zip(batches, draws):
        images = _t(batch["image"], device, torch.float32)
        losses = det.train_losses(images, ground_truth(batch, device), d)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        total.backward()
        out = {k: float(v.detach()) for k, v in losses.items()
               if k.startswith("loss")}
        out["total"] = float(total.detach())
        per_rank.append(out)
    n = len(batches)
    for p in det.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad /= n
    opt.step()
    sched.step()
    return {k: sum(r[k] for r in per_rank) / n for k in per_rank[0]}
