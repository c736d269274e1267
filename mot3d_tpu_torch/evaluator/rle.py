"""RLE binary-mask codec, numpy (counterpart of `mot3d_tpu/evaluator/rle.py`
without its optional ctypes binding of `native/lib/librle.so`, which is not
ported: ROADMAP.md Queue 1).

Same public contract as the reference's vendored pycocotools wrapper
(`Detection/evaluator/mask.py:1-29` / `_mask.pyx`): Fortran-order masks,
COCO-compatible compressed strings, encode/decode/merge/iou/area/bbox.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.uint32)


def encode(mask: np.ndarray) -> Dict:
    """Binary mask (h, w) -> {"size": [h, w], "counts": uint32 array}."""
    h, w = mask.shape
    fmask = np.asfortranarray(mask, dtype=np.uint8).reshape(-1, order="F")
    change = np.nonzero(np.diff(fmask))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [fmask.size]])
    runs = (ends - starts).astype(np.uint32)
    if fmask[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return {"size": [h, w], "counts": runs}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _u32(rle["counts"])
    vals = np.arange(len(counts)) % 2
    out = np.repeat(vals.astype(np.uint8), counts)
    out = np.pad(out[:h * w], (0, max(0, h * w - out.size)))
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
        ma = decode({"size": [h, w], "counts": acc})
        mb = decode({"size": [h, w], "counts": b})
        acc = encode(np.logical_and(ma, mb) if intersect
                     else np.logical_or(ma, mb))["counts"]
    return {"size": [h, w], "counts": acc}


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
    for i, d in enumerate(dts):
        md = decode(d).astype(bool)
        ad = md.sum()
        for j, g in enumerate(gts):
            mg = decode(g).astype(bool)
            inter = np.logical_and(md, mg).sum()
            denom = ad if crowd[j] else ad + mg.sum() - inter
            out[i, j] = inter / denom if denom else 0.0
    return out


def to_string(rle: Dict) -> bytes:
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


def from_string(s: bytes, size) -> Dict:
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


def bbox(rle: Dict) -> np.ndarray:
    """Tight [x, y, w, h] box of the mask."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)
