"""Typed configuration tree of the PyTorch port.

The port's own copy of `mot3d_tpu/config.py`: the same dataclasses, fields
and defaults, so one override string configures both packages the same way.
It replaces the reference's four uncoordinated config mechanisms
(detectron2 CfgNode `Detection/cfg_setup.py:10-141`, argparse
`Tracking/options.py:12-135`, dict `Tracking/graph_cfg.py:3-35`, EasyDict
`baseconfig.py:4-41`) with one dataclass tree.  Every magic constant in the
reference (objectness 0.35, 2D IoU 0.35, 3D IoU 0.01, L2 gate 0.4,
fx=292.87803547399, ...) is a named field here.

Every value the JAX package accepts is implemented; an unknown value is
rejected with a `ValueError` where it is read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


# MOTFront class names; reference `Detection/train_combined.py:584`.
MOTFRONT_CLASSES: Tuple[str, ...] = (
    "chair", "table", "sofa", "bed", "tv_stand", "cooler", "night_stand",
)


@dataclass(frozen=True)
class CameraConfig:
    """MOTFront pinhole camera; reference `PoseEst/pose_estimation.py:269-288`."""
    height: int = 240
    width: int = 320
    # Focal length from BlenderProc (fov=1); `PoseEst/pose_estimation.py:275`.
    fx: float = 292.87803547399
    fy: float = 292.87803547399

    @property
    def cx(self) -> float:
        # 0,0 is the center of the top-left pixel -> -0.5.
        return self.width / 2 - 0.5

    @property
    def cy(self) -> float:
        return self.height / 2 - 0.5


@dataclass(frozen=True)
class PoseConfig:
    """RANSAC + Umeyama solver; reference `PoseEst/pose_utils.py:63-117`."""
    ransac_iters: int = 100
    ransac_sample_size: int = 10
    # estimateSimilarityTransform fails below this inlier ratio (`pose_utils.py:105`).
    min_inlier_ratio: float = 0.1
    # PassThreshold multiplier (`pose_utils.py:95`, ratio_adapt).
    ratio_adapt: float = 1.0
    # StopThreshold = PassThreshold / stop_divisor (`pose_utils.py:96`).
    stop_divisor: float = 100.0
    # Statistical outlier removal (`pose_estimation.py:311-349`).
    outlier_nb_neighbors: int = 20
    outlier_std_ratio: float = 2.0
    # Skip outlier removal below this many points (`pose_estimation.py:311,341`).
    outlier_min_points: int = 100
    # Neighbour-candidate subset for the kNN statistic: each point searches an
    # evenly strided subset of this many columns (nb_neighbors scaled by the
    # same fraction).  0 = all points (open3d-exact candidate set).
    outlier_candidates: int = 256
    # clean_depth keeps cleaned points only if >20 remain (`pose_estimation.py:296`).
    clean_depth_min_points: int = 20
    # Fixed-size point buffer per object (padding cap; static shapes).
    max_points: int = 1024
    # Point extraction: "grid" samples a sqrt(max_points)^2 pixel grid
    # inside the box (plain tensor code, pose/extraction.py); "pallas" runs
    # the fused extraction kernel (ops/cuda/pose_extract.py on the GPU, the
    # same outputs); "full" pastes the mask to the full image and compacts
    # its valid pixels (pose/pipeline.py:full_extract).  All feed the same
    # outlier removal + RANSAC.
    extraction: str = "grid"
    # Rotation solver: "quat" (Horn quaternion via power iteration) or
    # "svd" (torch.linalg.svd).
    solver: str = "quat"
    # Whether pose gradients flow back to the NOCS head.  The reference
    # detaches (`Detection/tracker/postprocess.py:151`); our solver is
    # differentiable, so this is a flag (default False = reference parity).
    differentiable: bool = False


@dataclass(frozen=True)
class DetectionConfig:
    """Mask R-CNN R50-FPN + NOCS/voxel heads; reference `Detection/cfg_setup.py`."""
    num_classes: int = 7
    # Input geometry (images are 240x320; padded to 256x320 for stride-32 FPN).
    image_height: int = 240
    image_width: int = 320
    pad_height: int = 256
    pad_width: int = 320
    pixel_mean: Tuple[float, float, float] = (59.64, 61.96, 64.02)  # cfg_setup.py:70 (RGB order after BGR->RGB)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Computation dtype for the detector's conv/dense ops ("float32" or
    # "bfloat16"); parameters stay float32 (standard mixed precision).
    compute_dtype: str = "float32"
    # Backbone.
    backbone_depth: int = 50
    backbone_width: float = 1.0
    fpn_channels: int = 256
    # Normalisation: "gn" (GroupNorm, from-scratch training default) or
    # "affine" (frozen per-channel scale+bias — the eval-time form of the
    # reference's FrozenBatchNorm/BatchNorm; required by the torch
    # checkpoint importer, importers/torch_ckpt.py).
    norm: str = "gn"
    # torch view() semantics in the voxel head's feature->volume reshape
    # (channel-major); set True (with norm="affine") for imported weights.
    voxel_torch_reshape: bool = False
    # Stage stride on the bottleneck 1x1 conv (detectron2 caffe-style R50
    # zoo weights, RESNETS.STRIDE_IN_1X1=True) vs the 3x3 (torchvision
    # style, our from-scratch default).  Imported checkpoints need True —
    # same weights compute a different function otherwise.
    stride_in_1x1: bool = False
    # RPN.
    rpn_pre_nms_topk_train: int = 2000
    rpn_post_nms_topk_train: int = 1000
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_test: int = 500
    rpn_nms_thresh: float = 0.7
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # Anchor centres sit at (i + anchor_offset) * stride.  0.5 (cell
    # centres) is our from-scratch default; detectron2's
    # DefaultAnchorGenerator uses 0.0, so the torch-checkpoint importer
    # configures 0.0 to decode imported RPN deltas exactly.
    anchor_offset: float = 0.5
    # ROI heads (cfg_setup.py:62-67).
    roi_batch_per_image: int = 512
    roi_positive_fraction: float = 0.20
    roi_iou_threshold: float = 0.75          # IOU_THRESHOLDS [0.75]
    score_thresh_test: float = 0.05          # combined setting (cfg_setup.py:122)
    # Fast (YOLACT-style, loop-free) NMS; set False for exact
    # detectron2-equivalent suppression (fixpoint iteration).
    fast_nms: bool = True
    # Inference batching of the per-image proposal/NMS/pooling chain in the
    # JAX package ("unroll" or "scan").  Both give identical outputs; the
    # port runs one per-image loop for either value.
    predict_mode: str = "scan"
    nms_thresh_test: float = 0.4             # combined setting (cfg_setup.py:123)
    detections_per_image: int = 16           # static max detections kept per image
    box_pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    # Head widths (scaled down only for tiny test configs).
    mask_head_width: int = 256
    box_head_width: int = 1024
    head_width_mult: float = 1.0
    fg_head_buffer: int = 128            # ROIs fed to voxel/NOCS heads
    # Voxel head (cfg_setup.py:77-88).
    voxel_on: bool = True
    voxel_loss_weight: float = 0.75
    voxel_pooler_resolution: int = 14
    voxel_grid: int = 32
    # NOCS head (cfg_setup.py:90-105).
    nocs_on: bool = True
    nocs_use_bin_loss: bool = False
    nocs_num_bins: int = 32
    nocs_loss_weight: float = 3.0            # 0.2 if bin loss
    nocs_iou_thres: float = 0.5
    nocs_pooler_resolution: int = 14
    nocs_output_size: int = 28
    # Max ground-truth / padded instances per frame (static shapes).
    max_instances: int = 12
    max_proposals: int = 512


@dataclass(frozen=True)
class GraphConfig:
    """MPN hyper-parameters; reference `Tracking/graph_cfg.py:3-35`."""
    undirected: bool = True
    time_aware_mp: bool = False
    use_leaky_relu: bool = True
    max_frame_dist: int = 5
    num_mp_steps: int = 4
    node_agg_fn: str = "mean"
    reattach_initial_nodes: bool = False
    reattach_initial_edges: bool = True
    edge_in_dim: int = 8
    edge_fc_dims: Tuple[int, ...] = (12,)
    edge_out_dim: int = 12
    node_dim: int = 16                       # voxel_encoding_size (mpn_trainer.py:50)
    edge_model_fc_dims: Tuple[int, ...] = (32, 12)
    node_model_fc_dims: Tuple[int, ...] = (20, 16)
    classifier_intermed_dim: int = 8


@dataclass(frozen=True)
class TrackingConfig:
    """Tracker + association gates; reference `Tracking/options.py`, `tracking_front.py:9-22`."""
    seq_len: int = 25
    max_frame_dist: int = 5
    undirected: bool = True
    # Min 3D IoU between pred and GT box for identity assignment
    # (`Tracking/mpn_trainer.py:46`, graph_dataset box_iou_thres).
    box_iou_thres: float = 0.01
    # MOTA L2^2 gate in metres^2 (`tracking_front.py:16`, l2_thres).
    mota_l2_gate: float = 0.4
    # Edge binarisation threshold (`tracking_front.py:269`).
    edge_threshold: float = 0.5
    # Static padded graph sizes.
    max_instances_per_frame: int = 8
    # Trainer options (`Tracking/options.py:59-74`).
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    num_epochs: int = 100
    batch_size: int = 2
    # Feature ablations (`Tracking/options.py`).
    use_appearance: bool = False             # --rel_app
    as_quaternion: bool = False              # --as_quaternion

    @property
    def max_nodes(self) -> int:
        return self.seq_len * self.max_instances_per_frame

    @property
    def max_directed_edges(self) -> int:
        # all (t, t+dt) frame pairs with dt in [1, max_frame_dist]
        n_pairs = sum(
            min(self.max_frame_dist, self.seq_len - 1 - t)
            for t in range(self.seq_len - 1)
        )
        return n_pairs * self.max_instances_per_frame ** 2


@dataclass(frozen=True)
class SiameseConfig:
    """Siamese (non-graph, `--use_graph=False`) tracker; reference
    `Tracking/trainer.py:33-171` + `Tracking/options.py:36-83`."""
    appearance_dim: int = 12                 # voxel_out_dim (trainer.py:48)
    edge_out_dim: int = 8                    # trainer.py:49
    classifier_intermed_dim: int = 16        # EdgeClassifier default for in_dim 32
    # Ablations (options.py:36-83).
    no_pose: bool = False                    # drop edge (relative-pose) encoder
    no_geo: bool = False                     # drop voxel (appearance) encoder
    use_triplet: bool = False                # triplet margin loss on embeddings
    use_l1: bool = False                     # L1 on sigmoid instead of BCE
    triplet_margin: float = 1.0              # trainer.py:93
    # Balanced-BCE clamps (trainer.py:819-827).
    pos_weight_max: float = 10.0
    logit_clamp: float = 100.0
    # Optimiser (options.py:59-74; same defaults as the graph trainer).
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    num_epochs: int = 100
    batch_size: int = 2


@dataclass(frozen=True)
class CombinedConfig:
    """End-to-end training; reference `Detection/train_combined.py`."""
    # Detection kept if objectness > 0.35 and 2D IoU vs GT >= 0.35
    # (`Detection/train_combined.py:507`, postprocess.py).
    objectness_thres: float = 0.35
    iou2d_thres: float = 0.35
    # Office/F2F (no-GT) objectness gate
    # (`Detection/tracker/postprocess.py:240,354` obj_threshold=0.01).
    objectness_office: float = 0.01
    # Voxel binarisation threshold (`Detection/tracker/postprocess.py`).
    voxel_thres: float = 0.5
    detection_lr: float = 8e-4
    detection_weight_decay: float = 5e-4
    # WarmupMultiStepLR shape for the detection solver
    # (`Detection/cfg_setup.py:109-114`).  The reference SHIPS neutral
    # values (warmup 0 iters / factor 1, no milestones, gamma 1 → constant
    # 8e-4), so these defaults are exact parity; set e.g.
    # lr_warmup_iters=1000 lr_warmup_factor=0.001 for the detectron2
    # default warmup on real-data runs.
    lr_warmup_iters: int = 0
    lr_warmup_factor: float = 1.0
    lr_steps: tuple = ()
    lr_gamma: float = 1.0
    tracking_lr: float = 1e-3
    tracking_weight_decay: float = 1e-4
    # One joint backward (detection total + tracking loss over both
    # parameter sets) instead of the reference's two backward calls
    # (`train_combined.py:546-553`); read by
    # `parallel/train_step.py:make_combined_train_step`.
    joint_grad: bool = True
    # Gradient accumulation over the windows of a combined batch (one
    # window's activations in flight).
    accum_windows: bool = False
    max_iter: int = 240_000
    eval_period: int = 1000
    checkpoint_period: int = 3000
    batch_size: int = 2


@dataclass(frozen=True)
class RunConfig:
    """Run/orchestration options: mesh, precision, IO, logging."""
    seed: int = 0
    data_axis: str = "data"
    num_devices: int = 0                     # 0 = all available
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    output_dir: str = "out"
    checkpoint_dir: str = "out/ckpt"
    log_every: int = 20
    profile: bool = False


@dataclass(frozen=True)
class Config:
    camera: CameraConfig = field(default_factory=CameraConfig)
    pose: PoseConfig = field(default_factory=PoseConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    siamese: SiameseConfig = field(default_factory=SiameseConfig)
    combined: CombinedConfig = field(default_factory=CombinedConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def default_config() -> Config:
    return Config()


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply `section.field=value` CLI overrides to a Config."""
    sections: dict = {}
    for ov in overrides:
        key, _, raw = ov.partition("=")
        section_name, _, field_name = key.partition(".")
        section = sections.get(section_name) or getattr(cfg, section_name)
        old = getattr(section, field_name)
        if isinstance(old, bool):
            val: Any = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, tuple):
            elem = type(old[0]) if old else float
            val = tuple(elem(x) for x in raw.split(","))
        else:
            val = raw
        sections[section_name] = dataclasses.replace(section, **{field_name: val})
    return dataclasses.replace(cfg, **sections)
