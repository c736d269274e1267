"""Checkpointing: one file per step plus best-by-metric pointers
(counterpart of `mot3d_tpu/train/checkpoints.py`, on `torch.save`).

A checkpoint is a train state's `state_dict()`: for the combined trainer
both models, both optimizer states, both LR scheduler states and the step.
"Best" checkpoints are kept per metric name with a JSON file of the running
bests, which survives restarts (the reference's best-by-MOTA
`check_save_models`, `Detection/train_combined.py:94-124`).  Every file is
written to a temporary name and renamed, so a killed run never leaves a
torn checkpoint.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "best_metrics.json")
        self.best: Dict[str, dict] = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.fullmatch, os.listdir(self.directory)) if m)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any) -> bool:
        """False means the save was skipped because the step exists already
        (callers that must not lose the state assert on it)."""
        path = self._path(step)
        if os.path.exists(path):
            return False
        _save(state.state_dict(), path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state_template: Any, step: Optional[int] = None
                ) -> Any:
        """Load the checkpoint of `step` (the latest by default) into
        `state_template` and return it; None when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state_template.load_state_dict(_load(self._path(step)))
        return state_template

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def update_best(self, metric_name: str, value: float, step: int,
                    state: Any, higher_is_better: bool = True) -> bool:
        """Save a best-by-metric checkpoint if `value` improves; True when
        a new best was recorded."""
        prev = self.best.get(metric_name)
        improved = (prev is None
                    or (value > prev["value"]) == higher_is_better
                    and value != prev["value"])
        if not improved:
            return False
        _save(state.state_dict(),
              os.path.join(self.directory, f"best_{metric_name}.pt"))
        self.best[metric_name] = {"value": float(value), "step": int(step)}
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.best, f, indent=2)
        os.replace(tmp, self._meta_path)
        return True

    def restore_best(self, metric_name: str, state_template: Any) -> Any:
        state_template.load_state_dict(_load(os.path.join(
            self.directory, f"best_{metric_name}.pt")))
        return state_template


def resume_trainer(trainer) -> Optional[int]:
    """Restore the latest full train state (params, both optimizer and
    scheduler states, step) into `trainer.state`, so a killed run continues
    where it stopped (detectron2's `resume_or_load(resume=True)`,
    `Detection/train_net.py:99-110`).  `trainer.state` must exist already
    (it is the restore template).  Returns the restored step, or None when
    the directory holds no checkpoint."""
    if trainer.state is None:
        raise RuntimeError("init_state() must run before resume")
    if trainer.ckpt.restore(trainer.state) is None:
        return None
    step = int(trainer.state.step)
    print(f"resumed training from step {step} ({trainer.ckpt.directory})")
    return step
