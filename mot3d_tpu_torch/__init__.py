"""mot3d_tpu_torch — the PyTorch/CUDA port of mot3d_tpu for NVIDIA Hopper.

The package mirrors the layout of the JAX package (`geometry/`, `pose/`,
`tracking/`, `models/`, `ops/`, `parallel/`) so each module's counterpart is
easy to find.  It imports torch, numpy and (for the Hungarian step of the
MOT metrics) scipy: never JAX, flax or anything of `mot3d_tpu`.  Public
functions keep the JAX package's layouts (NHWC images, (..., 28, 28, 3) NOCS
patches, (N, 32, 32, 32) voxels); channel-first permutes happen inside the
modules.

Entry points (`parallel.infer_step.make_sequence_infer_step`, the train
steps of `parallel.train_step`, `train.combined_trainer.CombinedTrainer`
and the model constructors) run on the GPU unless the caller passes
`device="cpu"`.  The
CUDA kernels under `ops/cuda/` are built from `csrc/` on their first use on
a CUDA tensor; a CPU tensor takes each kernel's plain PyTorch version.
"""

from mot3d_tpu_torch.config import Config, default_config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.importers.flax_params import import_config
from mot3d_tpu_torch.tracking.tracker import Tracker

__all__ = ["Config", "Tracker", "default_config", "import_config",
           "resolve_device"]
