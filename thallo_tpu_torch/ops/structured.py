"""Structured-index detection: piecewise-affine segmentation of a flat
index array (the detection half of ``thallo_tpu/ops/structured.py``,
copied; numpy only).

An index array is structured when it is a concatenation of affine boxes

    idx[e0 + r*W + t] == base + r*row_coeff + t*col_coeff
    (r in [0,H), t in [0,W))

The JAX package lowers gathers through such boxes to windowed slices and
keys block-sparse row tables by segment.  The port runs only the
detection: the residual sort (reorder.py) and the row-table choice
(solver/blocksparse.py) decide from it exactly as the JAX package does.
The windowed apply is not ported (ROADMAP queue 1, item 5).

Disable with THALLO_AFFINE=0, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def enabled() -> bool:
    return os.environ.get("THALLO_AFFINE", "1") != "0"


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------
# A segment: (start, H, W, base, row_coeff, col_coeff) meaning
#   idx[start + r*W + t] == base + r*row_coeff + t*col_coeff
# for r in [0, H), t in [0, W).  Segments tile [0, len(idx)) in order.
Segment = Tuple[int, int, int, int, int, int]


def detect_segments(idx: np.ndarray, max_segments: int = 32
                    ) -> Optional[Tuple[Segment, ...]]:
    """Greedy affine-box segmentation of a flat index array.  Returns a
    tuple of segments tiling [0, len) or None if the array needs more
    than max_segments (i.e. is unstructured)."""
    idx = np.asarray(idx).astype(np.int64).reshape(-1)
    R = idx.size
    if R < 2:
        return None
    d = np.diff(idx)
    # positions where the inner stride breaks (row jumps / segment ends)
    segs: List[Segment] = []
    s = 0
    while s < R:
        if len(segs) >= max_segments:
            return None
        if s == R - 1:
            segs.append((s, 1, 1, int(idx[s]), 0, 1))
            s += 1
            continue
        c2 = int(d[s])
        # maximal run of inner stride c2 starting at s
        run = d[s:]
        brk = np.flatnonzero(run != c2)
        if brk.size == 0:
            # one affine row to the end
            segs.append((s, 1, R - s, int(idx[s]), 0, c2))
            break
        W = int(brk[0]) + 1
        c1 = int(idx[s + W] - idx[s]) if s + W < R else 0
        # extend to H rows: idx[s + r*W + t] == idx[s] + r*c1 + t*c2
        H = 1
        max_rows = (R - s) // W
        if max_rows > 1:
            block = idx[s:s + max_rows * W].reshape(max_rows, W)
            expect = (int(idx[s]) + np.arange(max_rows, dtype=np.int64)[:, None] * c1
                      + np.arange(W, dtype=np.int64)[None, :] * c2)
            rows_ok = np.all(block == expect, axis=1)
            H = int(np.argmin(rows_ok)) if not rows_ok.all() else max_rows
            H = max(H, 1)
        segs.append((s, H, W, int(idx[s]), c1, c2))
        s += H * W
    return tuple(segs)


_DETECT_MEMO: dict = {}


def detect_segments_cached(idx: np.ndarray, max_segments: int = 32
                           ) -> Optional[Tuple[Segment, ...]]:
    """detect_segments with a small content-keyed memo: init runs
    detection on the same index arrays from both prepared_consts (slot
    plans) and build_group_bsr (table keying)."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(idx).reshape(-1))
    key = (a.shape[0], max_segments,
           hashlib.blake2b(a.tobytes(), digest_size=16).digest())
    if key not in _DETECT_MEMO:
        if len(_DETECT_MEMO) > 64:
            _DETECT_MEMO.clear()
        _DETECT_MEMO[key] = detect_segments(a, max_segments)
    return _DETECT_MEMO[key]


def normalize_segments(segs, max_segments: int = 32, split_limit: int = 4,
                       allow_broadcast_rows: bool = False
                       ) -> Optional[Tuple[Segment, ...]]:
    """Make every segment independently executable and overlap-free:
    boxes whose rows overlap in value space (row_coeff < W, e.g. two
    direction groups greedily merged into one box) are split into
    single-row runs when small.  allow_broadcast_rows keeps
    identical-row boxes (c1 == 0) whole — fine for gather plans
    (window broadcasts), NOT for BSR column keying (an unknown would
    repeat within the segment).  Returns None when the result would be
    unstructured (too many segments / strided rows)."""
    if segs is None:
        return None
    norm: List[Segment] = []
    for (s0, H, W, b, c1, c2) in segs:
        if c2 == 0:
            # uniform repeat (e.g. sorted observation->point maps):
            # executable directly as a strided slice + broadcast
            if H > 1 and c1 < 0:
                return None
            norm.append((s0, H, W, b, c1, 0))
            continue
        if c2 != 1:
            return None
        if H > 1 and c1 < W:
            if allow_broadcast_rows and c1 == 0:
                norm.append((s0, H, W, b, 0, 1))  # identical rows
            elif H > split_limit:
                return None
            else:
                for r in range(H):
                    norm.append((s0 + r * W, 1, W, b + r * c1, 0, 1))
        else:
            norm.append((s0, H, W, b, c1, c2))
    if len(norm) > max_segments:
        return None
    return tuple(norm)
