"""The CPU side of the port's kernels K1 and K2, against the JAX package.

K1's plain version (what `knn_mean_dists` computes on a CPU tensor, and
what the CUDA kernel is held to on the card) gives 0 for an invalid point;
on every case of `torch_port_helpers.knn_cases` it must agree with the
Pallas kernel `knn_mean_dists_pallas` in interpret mode on the valid points
(1e-5, relative for far points: the expanded d2 cancels, so its rounding
grows with |p|^2) and give the same kept masks after the mean + 2 sigma
threshold.  The launch-geometry helpers must stay inside what a Hopper
block may use for every k and every accepted shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mot3d_tpu.geometry.outlier import _threshold_keep as keep_j
from mot3d_tpu.ops.pallas.knn_outlier import knn_mean_dists_pallas
from mot3d_tpu_torch.geometry.outlier import _threshold_keep as keep_t
from mot3d_tpu_torch.ops.cuda import knn_outlier as k1
from mot3d_tpu_torch.ops.cuda import pose_extract as k2
from torch_port_helpers import knn_cases

torch.set_num_threads(1)
CASES = knn_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_knn_plain_matches_pallas_interpret(name):
    pts, valid, cols, k = CASES[name]
    got = k1.knn_mean_dists(torch.from_numpy(pts), torch.from_numpy(valid),
                            torch.from_numpy(cols), k).numpy()
    assert got.shape == valid.shape
    cj = jnp.asarray(cols)
    keep = jax.jit(keep_j, static_argnums=(2, 3))
    for b in range(pts.shape[0]):
        want = np.asarray(knn_mean_dists_pallas(
            jnp.asarray(pts[b]), jnp.asarray(pts[b][cols]),
            jnp.asarray(valid[b][cols]), cj, k, interpret=True))
        v = valid[b]
        np.testing.assert_allclose(got[b][v], want[v], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name}[{b}]")
        assert not got[b][~v].any(), f"{name}[{b}]: invalid rows not 0"
        for min_points in (1, 100):
            kt = keep_t(torch.from_numpy(got[b]), torch.from_numpy(v), 2.0,
                        min_points).numpy()
            kj = np.asarray(keep(jnp.asarray(want), jnp.asarray(v), 2.0,
                                 min_points))
            np.testing.assert_array_equal(kt, kj, err_msg=f"{name}[{b}]")


def test_knn_instances_cover_every_k_and_fit_a_block():
    """Every k in 1..32 maps to the narrowest compiled width with at least k
    slots; the block fits Hopper's limits (threads, the 48 KB of dynamic
    shared memory a launch gets without opting in) at the largest C."""
    assert list(k1.KSLOTS) == sorted(k1.KSLOTS) and k1.KSLOTS[-1] == k1.MAX_K
    for k in range(1, k1.MAX_K + 1):
        assert k1.kslots_for(k) == min(w for w in k1.KSLOTS if w >= k)
    # The default configuration's widths are exact instances.
    assert k1.kslots_for(5) == 5 and k1.kslots_for(20) == 20
    assert k1.THREADS % 32 == 0 and k1.THREADS <= 1024
    assert k1.smem_bytes(k1.MAX_CANDIDATES) <= 48 * 1024
    assert k1.smem_bytes(1) == 129 * 20 + 128 * 8


def test_pose_extract_shared_memory_fits_a_block():
    """K2's shared memory (patch, axis tables, one staged round) at the
    path's shapes and at the largest patch fits a Hopper block; a grid
    whose axis tables would not fit is refused by the wrapper's check."""
    assert k2.smem_bytes(28, 32) == 16 + 16 * 28 * 28 + 48 * 32 + 25 * 1024
    assert k2.smem_bytes(28, 32) <= 48 * 1024        # no opt-in needed
    assert k2.smem_bytes(k2.MAX_PATCH, 1024) <= k2.SMEM_LIMIT
    assert k2.smem_bytes(k2.MAX_PATCH, 4096) > k2.SMEM_LIMIT
