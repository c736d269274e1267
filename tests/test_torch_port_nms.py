"""Exact NMS of the port (K3's wrapper logic and its plain version) against
the JAX package, on the CPU.

Every case goes through four routes that must keep exactly the same boxes:
  - `mot3d_tpu.ops.nms.nms_mask(exact=True)` (the JAX fixpoint);
  - `mot3d_tpu.ops.pallas.nms_kernel.pallas_nms_mask`, the TPU kernel, in
    interpret mode (patched as tests/test_ops.py does; the JAX package is
    not changed);
  - the port's `nms_mask(exact=True)`, which on a CPU tensor is the
    sort-free fixpoint;
  - the port's `exact_nms_mask`, K3's wrapper, which on a CPU tensor is
    its plain version `exact_nms_mask_plain` (stable sort, the plain scan
    `nms_sorted_plain`, unsort).
No tolerance: kept masks are compared for equality.  The kernel itself
runs only on the card (tests/test_torch_port_gpu.py); here the layout the
wrapper hands it is checked against every problem's elements.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mot3d_tpu.ops import nms as nms_j
from mot3d_tpu.ops.pallas import nms_kernel
from mot3d_tpu_torch.ops import nms as nms_t
from mot3d_tpu_torch.ops.cuda import nms as k3
from torch_port_helpers import nms_cases, to_torch

torch.set_num_threads(1)

CASES = nms_cases()


def _pallas_interpret(boxes, scores, valid, thresh):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(nms_kernel.pl, "pallas_call", interp):
        flat = [np.asarray(nms_kernel.pallas_nms_mask(
            jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thresh))
            for b, s, v in zip(boxes.reshape(-1, *boxes.shape[-2:]),
                               scores.reshape(-1, scores.shape[-1]),
                               valid.reshape(-1, valid.shape[-1]))]
    return np.stack(flat).reshape(valid.shape)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_nms_matches_jax_and_pallas(name):
    boxes, scores, valid, thresh = CASES[name]
    want = np.asarray(jax.jit(jax.vmap(
        lambda b, s, v: nms_j.nms_mask(b, s, v, thresh, exact=True)))(
        *(jnp.asarray(a.reshape((-1,) + a.shape[valid.ndim - 1:]))
          for a in (boxes, scores, valid)))).reshape(valid.shape)
    np.testing.assert_array_equal(
        _pallas_interpret(boxes, scores, valid, thresh), want)
    args = [to_torch(a) for a in (boxes, scores, valid)]
    before = k3.launches.count
    np.testing.assert_array_equal(
        nms_t.nms_mask(*args, thresh, exact=True).numpy(), want)
    np.testing.assert_array_equal(
        k3.exact_nms_mask(*args, thresh).numpy(), want)
    assert k3.launches.count == before      # no kernel on a CPU tensor
    assert not want[~valid].any()


@pytest.mark.parametrize("name", ["tied_scores", "batch_dims",
                                  "several_invalid"])
def test_sort_puts_ties_in_index_order_and_invalid_last(name):
    """The scan sees what the sort-free predicate `higher(i, j)` implies:
    descending scores, equal scores by index, invalid boxes at the end."""
    boxes, scores, valid, thresh = CASES[name]
    seen = {}

    def spy(boxes_s, valid_s, thr):
        seen["boxes"], seen["valid"] = boxes_s, valid_s
        return k3.nms_sorted_plain(boxes_s, valid_s, thr)

    k3.exact_nms_mask_plain(*(to_torch(a) for a in (boxes, scores, valid)),
                            thresh, scan=spy)
    order = np.lexsort((np.broadcast_to(np.arange(valid.shape[-1]),
                                        valid.shape),
                        np.where(valid, -scores, np.inf)), axis=-1)
    np.testing.assert_array_equal(
        seen["boxes"].numpy(),
        np.take_along_axis(boxes, order[..., None], -2))
    v_sorted = seen["valid"].numpy()
    assert (v_sorted[..., :-1] >= v_sorted[..., 1:]).all()


def test_classwise_nms_matches_jax():
    rng = np.random.default_rng(5)
    p, c = 40, 3
    xy = rng.uniform(0, 60, (2, p, c, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (2, p, c, 2))],
                           -1).astype(np.float32)
    scores = np.round(rng.uniform(size=(2, p, c)), 2).astype(np.float32)
    valid = rng.uniform(size=(2, p, c)) < 0.8
    for exact in (True, False):
        want = np.asarray(jax.jit(jax.vmap(
            lambda b, s, v: nms_j.classwise_nms_mask(b, s, v, 0.4, exact)))(
            *map(jnp.asarray, (boxes, scores, valid))))
        got = nms_t.classwise_nms_mask(*(to_torch(a) for a in
                                         (boxes, scores, valid)), 0.4, exact)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_route_is_refused_off_the_cpu_and_the_gpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never computed by the plain version."""
    boxes, scores, valid, thresh = CASES["random_0.4"]
    args = [to_torch(a).to("meta") for a in (boxes, scores, valid)]
    with pytest.raises(ValueError, match="device"):
        nms_t.nms_mask(*args, thresh, exact=True)


def _problem_offsets(layout, q):
    """Element offsets of problem q in boxes, scores, valid and keep, the
    way the kernel decomposes its problem index."""
    size, rest = layout[:k3.MAX_LEAD], layout[k3.MAX_LEAD:]
    strides = [rest[:6], rest[6:11], rest[11:16], rest[16:21]]
    offs = [0, 0, 0, 0]
    for d in reversed(range(k3.MAX_LEAD)):
        i, q = q % size[d], q // size[d]
        offs = [o + i * st[d] for o, st in zip(offs, strides)]
    return offs, strides


@pytest.mark.parametrize("view,merged", [("contiguous", [6]),
                                         ("movedim", [2, 3]),
                                         ("sliced", [2, 3]),
                                         ("single", [])])
def test_launch_layout_reaches_every_problem(view, merged):
    """The offset the kernel computes from `launch_layout` for each problem
    is that problem's own in all four tensors, for the class-wise
    `movedim` view too, whose leading dimensions do not merge."""
    b, c, p = 2, 3, 7
    boxes = torch.zeros(b, p, c, 4).movedim(2, 1)           # (b, c, p, 4)
    scores = torch.zeros(b, p, c).movedim(2, 1)
    if view == "contiguous":
        boxes, scores = boxes.contiguous(), scores.contiguous()
    elif view == "sliced":
        boxes, scores = boxes[:, :, 1:], scores[:, :, 1:]
    elif view == "single":
        boxes, scores = boxes[0, 1], scores[0, 1]
    valid = scores > 0
    keep = torch.empty_like(valid)
    tensors = (boxes, scores, valid, keep)
    layout = k3.launch_layout(*tensors)
    assert len(layout) == 25
    assert layout[:k3.MAX_LEAD] == [1] * (4 - len(merged)) + merged
    lead = scores.shape[:-1]
    for q, idx in enumerate(np.ndindex(*lead)):
        offs, strides = _problem_offsets(layout, q)
        for t, off, st in zip(tensors, offs, strides):
            assert off == sum(i * s for i, s in zip(idx, t.stride()))
            assert st[k3.MAX_LEAD] == t.stride(len(lead))
    assert strides[0][k3.MAX_LEAD + 1] == boxes.stride(-1)
