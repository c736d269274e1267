"""A tiny cell for the CPU tests: the configuration files' layout at 64 x
64 with a quarter-width backbone (the sizes of the port's data-parallel
dry run), 2-frame sequences and 4 detections a frame, and the cells'
traffic kinds at a few calls."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TINY = {
    "camera": {"height": 64, "width": 64, "fx": 64.0, "fy": 64.0},
    "detection": {"pad_height": 64, "pad_width": 64, "image_height": 64,
                  "image_width": 64, "rpn_pre_nms_topk_train": 128,
                  "rpn_post_nms_topk_train": 32, "rpn_pre_nms_topk_test": 64,
                  "rpn_post_nms_topk_test": 16, "roi_batch_per_image": 16,
                  "detections_per_image": 4, "max_instances": 3,
                  "anchor_sizes": [16, 32, 64, 128, 256],
                  "backbone_width": 0.25, "fpn_channels": 64,
                  "mask_head_width": 32, "box_head_width": 128,
                  "head_width_mult": 0.125, "fg_head_buffer": 8},
    "tracking": {"seq_len": 2, "max_instances_per_frame": 4,
                 "max_frame_dist": 1},
    "pose": {"max_points": 128, "ransac_iters": 16,
             "outlier_min_points": 16},
}


def tiny_config(name: str = "r50fpn-gn") -> dict:
    """The configuration file `name` with the tiny sizes."""
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    conf = copy.deepcopy(conf)
    for sec, vals in TINY.items():
        conf["config"][sec].update(vals)
    conf["name"] = name + "-tiny"
    return conf


def tiny_cell(name: str, config: str, limits: dict | None = None,
              clients: int = 2, ranks: int = 1) -> dict:
    """A cell dict as `common.cell` returns it, on the tiny config;
    training over `ranks` data-parallel ranks where that is above 1."""
    serve = name.startswith("serve")
    traffic = ({"kind": "sequences", "clients": clients, "pool": 2,
                "objects": 2, "pan_m": 0.02,
                "trace_window": {"stages_from": 0.4, "profile_from": 0.7,
                                 "profile_seconds": 0.5}}
               if serve else
               {"kind": "detection_batches", "batch": 2, "pool": 4,
                "objects": 2, "pan_m": 0.02,
                "trace_window": {"profile_from": 0.5,
                                 "profile_seconds": 0.5}})
    if ranks > 1:
        traffic["ranks"] = ranks
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if serve:
        work["check"].update(first_calls=2, per_client=1)
    if limits is not None:
        work["limits"] = limits
    return {"name": name, "entry": {"name": name, "chips": 1},
            "config": tiny_config(config), "traffic": traffic,
            "workload": work, "end_to_end": [], "per_layer": [],
            "metrics_dir": str(HERE / "metrics")}
