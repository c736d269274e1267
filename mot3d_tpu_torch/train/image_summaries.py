"""Image summaries: voxel renders + NOCS patch panels (a copy of
`mot3d_tpu/train/image_summaries.py`).

The reference writes matplotlib voxel plots and NOCS patch images to
tensorboard during eval (`Detection/evaluator/FrontEvaluator.py:293-333`
put_image of pred/GT voxel renders; `:442-452` NOCS patches).  Equivalents
here are dependency-light numpy renders:

  - `render_voxel_views`: pred|GT occupancy grids as three depth-shaded
    orthographic projections (top/front/side), tiled into one RGB image;
  - `render_nocs_panel`: predicted vs GT NOCS patches side by side (NOCS
    values ARE RGB colours in [0, 1]);

written as PNGs under <out>/images/ and, when the `tensorboard` package is
present (it is optional), mirrored with tf.summary-compatible event files
via `torch.utils.tensorboard.SummaryWriter`.  matplotlib, cv2 (or PIL) and
tensorboard are imported inside the functions that use them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _depth_shaded_projection(grid: np.ndarray, axis: int) -> np.ndarray:
    """(R, R, R) bool -> (R, R) float in [0, 1]: nearest occupied cell along
    `axis` rendered bright, farther cells darker, empty = 0."""
    r = grid.shape[axis]
    idx = np.arange(r, dtype=np.float64)
    shape = [1, 1, 1]
    shape[axis] = r
    depth = np.where(grid, idx.reshape(shape), np.inf)
    near = depth.min(axis)
    hit = np.isfinite(near)
    shade = np.zeros(near.shape)
    shade[hit] = 1.0 - 0.7 * near[hit] / max(r - 1, 1)
    return shade


def render_voxel_views(pred_grid: np.ndarray,
                       gt_grid: Optional[np.ndarray] = None,
                       upscale: int = 4) -> np.ndarray:
    """Pred (and optionally GT) 32^3 grids -> one (H, W, 3) uint8 image:
    rows = grids, columns = top/front/side projections."""
    rows = []
    for grid, chan in ((pred_grid, 0), (gt_grid, 1)):
        if grid is None:
            continue
        g = np.asarray(grid) >= 0.5
        views = [_depth_shaded_projection(g, ax) for ax in range(3)]
        strip = np.concatenate(views, axis=1)  # (R, 3R)
        rgb = np.zeros(strip.shape + (3,))
        rgb[..., chan] = strip            # pred = red, GT = green
        rgb[..., 2] = strip * 0.25
        rows.append(rgb)
    img = np.concatenate(rows, axis=0)
    img = np.repeat(np.repeat(img, upscale, 0), upscale, 1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_nocs_panel(pred_nocs: np.ndarray,
                      gt_nocs: Optional[np.ndarray] = None,
                      upscale: int = 6) -> np.ndarray:
    """(P, P, 3) NOCS values in [0,1] -> side-by-side pred|GT uint8 image
    (`FrontEvaluator.py:442-452`)."""
    panels = [np.asarray(pred_nocs, np.float64)]
    if gt_nocs is not None:
        panels.append(np.ones((pred_nocs.shape[0], 2, 3)))  # separator
        panels.append(np.asarray(gt_nocs, np.float64))
    img = np.concatenate(panels, axis=1)
    img = np.repeat(np.repeat(img, upscale, 0), upscale, 1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_class_bars(values: "dict[str, float]", title: str = "",
                      ylabel: str = "") -> np.ndarray:
    """Per-class bar chart -> (H, W, 3) uint8 (the reference's per-class
    AP tensorboard plots, `EvaluatorUtils.py:358-415` save_ap, and the
    per-class rotation/location error renders in FrontEvaluator)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 3), dpi=100)
    names = list(values)
    ax.bar(range(len(names)), [values[k] for k in names],
           color="#377eb8")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_title(title, fontsize=10)
    ax.set_ylabel(ylabel, fontsize=8)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def render_histogram(values, title: str = "", xlabel: str = "",
                     bins: int = 20) -> np.ndarray:
    """Per-instance error histogram -> (H, W, 3) uint8 (FrontEvaluator's
    per-instance rotation/location error distributions)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 3), dpi=100)
    v = np.asarray(list(values), np.float64)
    ax.hist(v, bins=bins, color="#4daf4a", edgecolor="white")
    if v.size:
        ax.axvline(float(np.median(v)), color="#e41a1c", lw=1.2,
                   label=f"median {np.median(v):.3g}")
        ax.legend(fontsize=8)
    ax.set_title(title, fontsize=10)
    ax.set_xlabel(xlabel, fontsize=8)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


class ImageWriter:
    """PNG files (always) + tensorboard events (when available)."""

    def __init__(self, output_dir: str):
        self.dir = os.path.join(output_dir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            return
        self._tb = SummaryWriter(os.path.join(output_dir, "tb"))

    def write_image(self, step: int, tag: str, image: np.ndarray) -> str:
        """image: (H, W, 3) uint8.  Returns the PNG path."""
        safe = tag.replace("/", "_")
        path = os.path.join(self.dir, f"{safe}_{step:07d}.png")
        _write_png(path, image)
        if self._tb is not None:
            self._tb.add_image(tag, image, global_step=step,
                               dataformats="HWC")
            self._tb.flush()
        return path

    def close(self):
        if self._tb is not None:
            self._tb.close()


def _write_png(path: str, image: np.ndarray) -> None:
    try:
        import cv2
        cv2.imwrite(path, np.asarray(image)[:, :, ::-1])
    except ImportError:  # pragma: no cover
        from PIL import Image
        Image.fromarray(np.asarray(image)).save(path)
