"""The port's native host libraries (`utils/native.py`, `evaluator/rle.py`,
`data/voxelize.py`) against their numpy plain versions and the JAX
package's functions, on the cases of `tests/test_evaluator_native.py`:
RLE counts, strings, boxes and IoU equal (exactly; IoU is a quotient of
the same integers on every side), voxel grids and point-in-mesh flags
equal.  The libraries are compiled from `native/` at first use; a failed
build raises instead of falling back to numpy."""

import numpy as np
import pytest

from mot3d_tpu.data import voxelize as vox_j
from mot3d_tpu.evaluator import rle as rle_j
from mot3d_tpu_torch.data import voxelize as vox_t
from mot3d_tpu_torch.evaluator import rle as rle_t
from mot3d_tpu_torch.utils import native


def _masks():
    """The masks of the JAX package's RLE tests, plus an empty, a full and
    a first-pixel-set mask."""
    rng = np.random.default_rng(21)
    out = [rng.uniform(size=(37, 53)) < 0.4 for _ in range(3)]
    out += [rng.uniform(size=(29, 31)) < 0.3 for _ in range(3)]
    for box in ((slice(2, 5), slice(3, 7)), (slice(1, 3), slice(1, 3)),
                (slice(5, 9), slice(10, 14)), (slice(0, 8), slice(None)),
                (slice(4, 12), slice(None))):
        m = np.zeros((20, 30), bool)
        m[box] = True
        out.append(m)
    full, first = np.ones((16, 16), bool), np.zeros((4, 4), bool)
    first[0, 0] = True
    return out + [np.zeros((10, 10), bool), full, first]


MASKS = _masks()


@pytest.mark.parametrize("i", range(len(MASKS)))
def test_rle_codec_matches_numpy_and_jax(i):
    m = MASKS[i]
    r = rle_t.encode(m)
    for other in (rle_t.encode_plain(m), rle_j.encode(m)):
        np.testing.assert_array_equal(r["counts"], other["counts"])
        assert r["size"] == other["size"]
    for dec in (rle_t.decode(r), rle_t.decode_plain(r)):
        np.testing.assert_array_equal(dec.astype(bool), m)
    s = rle_t.to_string(r)
    assert s == rle_t.to_string_plain(r) == rle_j.to_string(r)
    for back in (rle_t.from_string(s, r["size"]),
                 rle_t.from_string_plain(s.decode(), r["size"])):
        np.testing.assert_array_equal(back["counts"], r["counts"])
    np.testing.assert_array_equal(rle_t.bbox(r), rle_t.bbox_plain(r))
    np.testing.assert_array_equal(rle_t.bbox(r), rle_j.bbox(r))
    assert rle_t.area(r) == int(m.sum())


def test_rle_known_vector():
    m = np.zeros((4, 4), bool)
    m[1:3, 1:3] = True
    np.testing.assert_array_equal(rle_t.encode(m)["counts"], [5, 2, 2, 2, 5])


def test_rle_merge_and_iou_match_numpy_and_jax():
    a = np.zeros((20, 20), bool)
    a[:10] = True
    b = np.zeros((20, 20), bool)
    b[5:15] = True
    ra, rb = rle_t.encode(a), rle_t.encode(b)
    for inter, want in ((False, a | b), (True, a & b)):
        got = rle_t.merge([ra, rb], inter)
        np.testing.assert_array_equal(rle_t.decode(got).astype(bool), want)
        np.testing.assert_array_equal(
            got["counts"], rle_t.merge_plain([ra, rb], inter)["counts"])
        np.testing.assert_array_equal(
            got["counts"], rle_j.merge([ra, rb], inter)["counts"])
    with pytest.raises(ValueError, match="empty"):
        rle_t.merge([])
    for same_size in (MASKS[:3], MASKS[6:11]):
        dts = [rle_t.encode(m) for m in same_size]
        gts = dts[::-1] + dts[:1]
        for crowd in (None, [j % 2 for j in range(len(gts))]):
            got = rle_t.iou(dts, gts, crowd)
            np.testing.assert_array_equal(got,
                                          rle_t.iou_plain(dts, gts, crowd))
            np.testing.assert_array_equal(got, rle_j.iou(dts, gts, crowd))
    full = rle_t.encode(np.ones((16, 16), bool))
    half = rle_t.encode(np.arange(256).reshape(16, 16) < 128)
    assert rle_t.iou([half], [full])[0, 0] == 0.5
    assert rle_t.iou([half], [full], [1])[0, 0] == 1.0
    assert rle_t.iou([], [full]).shape == (0, 1)


def _cube_mesh(lo=0.25, hi=0.75):
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


@pytest.mark.parametrize("box, want", [
    (([0.2, 0.2, 0.0], [0.1, 0.1, 0.1]), True),
    (([2.0, 2.0, 2.0], [0.1, 0.1, 0.1]), False),
    (([0.2, 0.2, 0.5], [0.1, 0.1, 0.1]), False),
    (([0.45, 0.45, 0.05], [0.1, 0.1, 0.04]), False)])
def test_tri_box_overlap(box, want):
    tri = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    for fn in (vox_t.tri_box_overlap, vox_t.tri_box_overlap_plain,
               vox_j.tri_box_overlap):
        assert fn(*box, tri) is want


@pytest.mark.parametrize("res", [8, 16])
def test_voxelize_matches_numpy_and_jax(res):
    v, f = _cube_mesh()
    surf = vox_t.voxelize_surface(v, f, res)
    np.testing.assert_array_equal(surf, vox_t.voxelize_surface_plain(v, f,
                                                                     res))
    np.testing.assert_array_equal(surf, vox_j.voxelize_surface(v, f, res))
    fill = vox_t.voxelize_fill(v, f, res)
    np.testing.assert_array_equal(fill, vox_t.voxelize_fill_plain(v, f, res))
    np.testing.assert_array_equal(fill, vox_j.voxelize_fill(v, f, res))
    c = res // 2
    assert surf[c, c, res // 4] and not surf[c, c, c] and fill[c, c, c]
    assert not fill[1, 1, 1]


def test_points_in_mesh_matches_numpy_and_jax():
    v, f = _cube_mesh()
    pts = np.array([[0.5, 0.5, 0.5], [0.1, 0.1, 0.1], [0.3, 0.3, 0.3],
                    [0.9, 0.5, 0.5]])
    pts = np.concatenate([pts, np.random.default_rng(3).uniform(
        size=(64, 3))])
    got = vox_t.points_in_mesh(v, f, pts)
    np.testing.assert_array_equal(got[:4], [True, False, True, False])
    np.testing.assert_array_equal(got, vox_t.points_in_mesh_plain(v, f,
                                                                  pts))
    np.testing.assert_array_equal(got, vox_j.points_in_mesh(v, f, pts))
    with pytest.raises(ValueError, match="indexes no vertex"):
        vox_t.points_in_mesh(v, f + 8, pts)


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    switches to numpy on its own.  The libraries land under build/native,
    stamped with their source's hash."""
    assert native.build("rle").path == native.BUILD_DIR / "librle.so"
    bad = tmp_path / "rle"
    bad.mkdir()
    (bad / "rle.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed") as err:
        native.build("rle")
    assert "error" in str(err.value)
    assert not (tmp_path / "build" / "librle.so").exists()
    with pytest.raises(ValueError, match="no native library"):
        native.build("nms")
