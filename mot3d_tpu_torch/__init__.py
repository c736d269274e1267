"""mot3d_tpu_torch — the PyTorch/CUDA port of mot3d_tpu for NVIDIA Hopper.

The package mirrors the layout of the JAX package (`geometry/`, `pose/`,
`tracking/`, `models/`, `ops/`, `parallel/`) so each module's counterpart is
easy to find.  It imports torch and numpy: never JAX, flax or anything of
`mot3d_tpu`.  Public
functions keep the JAX package's layouts (NHWC images, (..., 28, 28, 3) NOCS
patches, (N, 32, 32, 32) voxels); channel-first permutes happen inside the
modules.

Entry points (`parallel.infer_step.make_sequence_infer_step`, the train
steps of `parallel.train_step`, the trainers of `train/`,
`export.DetectorExporter`, `data.prefetch.device_prefetch`, the CLI
`python -m mot3d_tpu_torch.cli`, `data.office.office_inference` and the
model constructors) run on the GPU unless the caller passes `device="cpu"`
(`--device cpu`).  Host packages of the file readers, summaries, MOT
metrics and smoothing (h5py, cv2, matplotlib, PIL, tensorboard, scipy)
are imported inside the functions that use them.  The
CUDA kernels under `ops/cuda/` are built from `csrc/` on their first use on
a CUDA tensor; a CPU tensor takes each kernel's plain PyTorch version.
The native host libraries of `native/` (the RLE codec, the voxelizer) are
built with g++ on their first use (`utils/native.py`).  Data parallelism
runs one rank per GPU over `torch.distributed` (`parallel/mesh.py`,
`parallel/multihost.py`; the steps' and `device_prefetch`'s `mesh=`).
"""

from mot3d_tpu_torch.config import Config, default_config
from mot3d_tpu_torch.device import resolve_device
from mot3d_tpu_torch.importers.torch_ckpt import import_config
from mot3d_tpu_torch.tracking.tracker import Tracker

__all__ = ["Config", "Tracker", "default_config", "import_config",
           "resolve_device"]
