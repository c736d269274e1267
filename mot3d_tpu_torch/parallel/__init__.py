"""Data parallelism over torch.distributed: the mesh and the train and
serving steps (counterpart of `mot3d_tpu/parallel/__init__.py`)."""

from mot3d_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from mot3d_tpu_torch.parallel.train_step import (
    CombinedTrainState,
    TrackingTrainState,
    make_combined_train_step,
    make_tracking_train_step,
)
from mot3d_tpu_torch.parallel.infer_step import (
    SequenceBatch,
    SequenceOutputs,
    make_sequence_infer_step,
)
