"""RLE binary-mask codec (counterpart of `mot3d_tpu/evaluator/rle.py`): the
C++ codec of `native/rle/rle.cpp` through ctypes, built at first use by
`utils/native.py`, with the numpy versions beside it as the plain
reference (`*_plain`).  Unlike the JAX package, which switches to numpy
when its library is missing, a failed build raises.

Same public contract as the reference's vendored pycocotools wrapper
(`Detection/evaluator/mask.py:1-29` / `_mask.pyx`): Fortran-order masks,
COCO-compatible compressed strings, encode/decode/merge/iou/area/bbox.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np

from mot3d_tpu_torch.utils import native

_I64 = ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The codec, with every entry point's signature declared."""
    lib = native.library("rle")
    for name, res, args in (
            ("rle_encode", _I64, [_U8P, _I64, _I64, _U32P]),
            ("rle_decode", None, [_U32P, _I64, _I64, _I64, _U8P]),
            ("rle_merge", _I64, [_U32P, _I64, _U32P, _I64, ctypes.c_int,
                                 _U32P]),
            ("rle_iou_matrix", None, [_U32P, _I64P, _I64, _U32P, _I64P,
                                      _I64, _U8P, _F64P]),
            ("rle_to_string", _I64, [_U32P, _I64, ctypes.c_char_p]),
            ("rle_from_string", _I64, [ctypes.c_char_p, _I64, _U32P]),
            ("rle_bbox", None, [_U32P, _I64, _I64, _I64, _F64P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _fortran(mask: np.ndarray) -> np.ndarray:
    return np.asfortranarray(mask, dtype=np.uint8).reshape(-1, order="F")


# ------------------------------------------------------------- native


def encode(mask: np.ndarray) -> Dict:
    """Binary mask (h, w) -> {"size": [h, w], "counts": uint32 array}."""
    h, w = mask.shape
    fmask = _fortran(mask)
    out = np.empty(h * w + 1, np.uint32)
    m = _lib().rle_encode(_ptr(fmask, _U8P), h, w, _ptr(out, _U32P))
    return {"size": [h, w], "counts": out[:m].copy()}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    out = np.empty(h * w, np.uint8)
    _lib().rle_decode(_ptr(counts, _U32P), len(counts), h, w,
                      _ptr(out, _U8P))
    return out.reshape((h, w), order="F")


def area(rle: Dict) -> int:
    counts = _u32(rle["counts"])
    return int(counts[1::2].sum())


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    if not rles:
        raise ValueError("merge of an empty list")
    acc = _u32(rles[0]["counts"])
    h, w = rles[0]["size"]
    for r in rles[1:]:
        b = _u32(r["counts"])
        out = np.empty(len(acc) + len(b) + 2, np.uint32)
        m = _lib().rle_merge(_ptr(acc, _U32P), len(acc), _ptr(b, _U32P),
                             len(b), int(intersect), _ptr(out, _U32P))
        acc = out[:m].copy()
    return {"size": [h, w], "counts": acc}


def _packed(rles: Sequence[Dict]):
    counts = np.concatenate([_u32(r["counts"]) for r in rles])
    off = np.concatenate([[0], np.cumsum([len(r["counts"]) for r in rles])
                          ]).astype(np.int64)
    return counts, off


def iou(dts: Sequence[Dict], gts: Sequence[Dict],
        iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """Pairwise IoU matrix (len(dts), len(gts)); crowd GT uses
    intersection/area(dt) (COCO convention)."""
    nd, ng = len(dts), len(gts)
    out = np.zeros((nd, ng), np.float64)
    if nd == 0 or ng == 0:
        return out
    crowd = np.asarray(iscrowd if iscrowd is not None else [0] * ng,
                       np.uint8)
    (dc, do), (gc, go) = _packed(dts), _packed(gts)
    _lib().rle_iou_matrix(_ptr(dc, _U32P), _ptr(do, _I64P), nd,
                          _ptr(gc, _U32P), _ptr(go, _I64P), ng,
                          _ptr(crowd, _U8P), _ptr(out, _F64P))
    return out


def to_string(rle: Dict) -> bytes:
    counts = _u32(rle["counts"])
    # At most 7 characters of 5 bits for a 33-bit signed difference.
    buf = ctypes.create_string_buffer(7 * len(counts) + 1)
    n = _lib().rle_to_string(_ptr(counts, _U32P), len(counts), buf)
    return buf.raw[:n]


def from_string(s: bytes, size) -> Dict:
    if isinstance(s, str):
        s = s.encode()
    out = np.empty(len(s) + 1, np.uint32)
    m = _lib().rle_from_string(s, len(s), _ptr(out, _U32P))
    return {"size": list(size), "counts": out[:m].copy()}


def bbox(rle: Dict) -> np.ndarray:
    """Tight [x, y, w, h] box of the mask."""
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    out = np.empty(4, np.float64)
    _lib().rle_bbox(_ptr(counts, _U32P), len(counts), h, w,
                    _ptr(out, _F64P))
    return out


# -------------------------------------------------------------- plain


def encode_plain(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    fmask = _fortran(mask)
    change = np.nonzero(np.diff(fmask))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [fmask.size]])
    runs = (ends - starts).astype(np.uint32)
    if fmask[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return {"size": [h, w], "counts": runs}


def decode_plain(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    vals = np.arange(len(counts)) % 2
    out = np.repeat(vals.astype(np.uint8), counts)
    out = np.pad(out[:h * w], (0, max(0, h * w - out.size)))
    return out.reshape((h, w), order="F")


def merge_plain(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    if not rles:
        raise ValueError("merge of an empty list")
    acc = _u32(rles[0]["counts"])
    h, w = rles[0]["size"]
    for r in rles[1:]:
        ma = decode_plain({"size": [h, w], "counts": acc})
        mb = decode_plain({"size": [h, w], "counts": r["counts"]})
        acc = encode_plain(np.logical_and(ma, mb) if intersect
                           else np.logical_or(ma, mb))["counts"]
    return {"size": [h, w], "counts": acc}


def iou_plain(dts: Sequence[Dict], gts: Sequence[Dict],
              iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    nd, ng = len(dts), len(gts)
    out = np.zeros((nd, ng), np.float64)
    crowd = np.asarray(iscrowd if iscrowd is not None else [0] * ng,
                       np.uint8)
    for i, d in enumerate(dts):
        md = decode_plain(d).astype(bool)
        ad = md.sum()
        for j, g in enumerate(gts):
            mg = decode_plain(g).astype(bool)
            inter = np.logical_and(md, mg).sum()
            denom = ad if crowd[j] else ad + mg.sum() - inter
            out[i, j] = inter / denom if denom else 0.0
    return out


def to_string_plain(rle: Dict) -> bytes:
    counts = _u32(rle["counts"])
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def from_string_plain(s: bytes, size) -> Dict:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": list(size), "counts": np.asarray(counts, np.uint32)}


def bbox_plain(rle: Dict) -> np.ndarray:
    m = decode_plain(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)
