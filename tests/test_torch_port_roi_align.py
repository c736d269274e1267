"""ROIAlign's gather kernel on the CPU side: the detector's pooling op
`ops/roi_align.py:roi_align_pyramid`, its autograd function and the launch
checks of `ops/cuda/roi_align.py` against the plain version,
`multilevel_roi_align_batched_packed`.

On CPU tensors `roi_align_pyramid` is the plain version bit for bit, and
`RoiAlignPyramid` gives the plain version's gradients (by autograd of the
plain forward) through the same gradient plumbing the kernels use: which
inputs get one, in which order.  Compared in float64 (1e-10 against
gradients of order 10).  The kernels themselves run on the card
(tests/test_torch_port_gpu.py).
"""

import numpy as np
import pytest
import torch

from mot3d_tpu_torch.ops.cuda import roi_align as ra
from mot3d_tpu_torch.ops.roi_align import (
    RoiAlignPyramid, assign_fpn_level, multilevel_roi_align_batched_packed,
    roi_align_pyramid)
from torch_port_helpers import ROI_STRIDES, roi_case

torch.set_num_threads(1)


def _case(seed, out, dtype=torch.float32):
    maps, boxes = roi_case(seed, 2, 26, 8, hw=(64, 80))
    return ([torch.from_numpy(m).to(dtype) for m in maps],
            torch.from_numpy(boxes).to(dtype))


@pytest.mark.parametrize("out", [7, 14])
def test_wrapper_takes_the_plain_version_on_the_cpu(out):
    maps, boxes = _case(0, out)
    before = ra.launches.count
    got = roi_align_pyramid(maps, boxes, out, ROI_STRIDES)
    want = multilevel_roi_align_batched_packed(maps, boxes, out, ROI_STRIDES)
    assert torch.equal(got, want) and got.shape == (2, 26, out, out, 8)
    assert ra.launches.count == before       # no kernel on a CPU tensor


@pytest.mark.parametrize("need", ["both", "maps", "boxes"])
@pytest.mark.parametrize("out", [7, 14])
def test_function_gives_the_plain_gradients(out, need):
    maps, boxes = _case(1, out, torch.float64)
    grad = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 26, out, out, 8)))

    def leaves():
        m = [x.clone().requires_grad_(need != "boxes") for x in maps]
        return m, boxes.clone().requires_grad_(need != "maps")

    m_ref, b_ref = leaves()
    (multilevel_roi_align_batched_packed(m_ref, b_ref, out, ROI_STRIDES)
     * grad).sum().backward()
    m_fn, b_fn = leaves()
    pooled = RoiAlignPyramid.apply(b_fn, out, ROI_STRIDES, 2, 2, *m_fn)
    assert torch.equal(pooled.detach(), multilevel_roi_align_batched_packed(
        maps, boxes, out, ROI_STRIDES))
    (pooled * grad).sum().backward()
    for got, want in [(b_fn, b_ref)] + list(zip(m_fn, m_ref)):
        if want.grad is None:
            assert got.grad is None
            continue
        assert float((got.grad - want.grad).abs().max()) < 1e-10
    if need != "maps":
        # Off-map and padded rows get no gradient; the rest do.
        assert float(b_ref.grad.abs().max()) > 1.0


def test_batched_level_assignment_equals_the_per_frame_one():
    """The kernel takes each box's level from one `assign_fpn_level` over
    the whole (B, N) batch; the plain version assigns frame by frame.  The
    cases hold squares within 3 ulps of 112, 224 and 448."""
    boxes = torch.from_numpy(roi_case(3, 5, 400, 4)[1])
    batched = assign_fpn_level(boxes)
    per_frame = torch.stack([assign_fpn_level(b) for b in boxes])
    assert torch.equal(batched, per_frame)
    assert set(batched.unique().tolist()) == {2, 3, 4, 5}


def test_wrapper_refuses_other_devices():
    maps, boxes = _case(0, 7)
    with pytest.raises(ValueError, match="device"):
        roi_align_pyramid([m.to("meta") for m in maps], boxes.to("meta"),
                             7, ROI_STRIDES)


@pytest.mark.parametrize("bad", ["dtype", "channels", "batch", "output",
                                 "sampling"])
def test_launch_checks_refuse_what_the_kernel_does_not_take(bad):
    maps, boxes = _case(0, 7)
    out, s = 7, 2
    if bad == "dtype":
        boxes = boxes.double()
    elif bad == "channels":
        maps = [m[:, :6] for m in maps]
    elif bad == "batch":
        boxes = boxes[:1]
    elif bad == "output":
        out = ra.MAX_OUTPUT + 1
    else:
        s = ra.MAX_SAMPLING + 1
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        ra._check(maps, boxes, out, ROI_STRIDES, s)
