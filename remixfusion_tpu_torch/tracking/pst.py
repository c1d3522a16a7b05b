"""Pre-Sampled Transformation (PST) candidate tables.

The reference ships 60 TIFF files of farthest-point-sampled 6-DoF candidate
sets on the 6D unit ball (PFO/fps_uniform_sphere, loaded in
model/ROtracker.py:834-866), organized as 3 tiers (10240/3072/1024
candidates) x ~7 slabs each. Rather than copying those data files, this
module GENERATES equivalent tables: deterministic uniform samples in the 6D
unit ball (Gaussian direction x radius^(1/6)), greedily reordered so early
rows are well spread (a cheap farthest-point pass on a subsample), with row
0 always the identity (zero) transform — the kernel treats candidate 0 as
the unperturbed pose (ROtracker.py:623).

If `pst_path` points at a directory with the reference's TIFF naming scheme
and cv2 is importable, tables are loaded from disk instead (user-supplied
data wins).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

# count_particle -> slab selection table (reference ROtracker.py:116-120).
TIFF_INDEX = [0, 21, 42, 3, 24, 45, 6, 27, 48, 9, 30, 51, 12, 33, 54,
              15, 36, 57, 18, 39]
# count_particle -> image pyramid stride (reference ROtracker.py:121).
DEPTH_LEVEL = [32, 16, 8] * 6 + [32, 16]


def _uniform_ball_6d(n: int, rng: np.random.Generator) -> np.ndarray:
    v = rng.standard_normal((n, 6))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.random((n, 1)) ** (1.0 / 6.0)
    return (v * r).astype(np.float32)


def _fps_reorder(pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Cheap greedy farthest-point ordering (exact for <= 4096 points,
    block-greedy beyond) so candidate prefixes stay well spread."""
    n = len(pts)
    if n > 4096:
        # order the first 4096 exactly; leave the tail shuffled
        head = _fps_reorder(pts[:4096], rng)
        tail = pts[4096:]
        return np.concatenate([head, tail], axis=0)
    order = [0]
    d = np.linalg.norm(pts - pts[0], axis=1)
    for _ in range(n - 1):
        i = int(d.argmax())
        order.append(i)
        d = np.minimum(d, np.linalg.norm(pts - pts[i], axis=1))
    return pts[order]


def generate_pst(size: int, slab: int) -> np.ndarray:
    rng = np.random.default_rng(100003 * size + 7919 * slab + 13)
    pts = _uniform_ball_6d(size, rng)
    pts = _fps_reorder(pts, rng)
    pts[0] = 0.0  # identity candidate first
    return pts


def _try_load_reference_tiffs(pst_path: str, sizes: List[int]):
    try:
        import cv2
    except Exception:
        return None
    tables: Dict[int, List[np.ndarray]] = {0: [], 1: [], 2: []}
    for idx in TIFF_INDEX:
        cls = idx // 20
        num = idx - cls * 20
        fname = os.path.join(pst_path, f"pst_{sizes[cls]}_{num}.tiff")
        if not os.path.exists(fname):
            return None
        arr = cv2.imread(fname, -1)
        if arr is None or arr.shape != (sizes[cls], 6):
            return None
        tables[cls].append(np.ascontiguousarray(arr, np.float32))
    return {c: np.stack(v) for c, v in tables.items()}


def load_pst(pst_path: str, sizes: List[int]) -> Dict[int, np.ndarray]:
    """Returns {class: [n_slabs, size, 6]} candidate arrays.

    n_slabs per class follows the reference layout: 7 / 7 / 6. Generated
    tables come from a process-wide cache keyed by `sizes` (generation takes
    seconds per set): every caller gets its own copies, so the pipelines of
    one process share no array.
    """
    if pst_path and os.path.isdir(pst_path):
        loaded = _try_load_reference_tiffs(pst_path, sizes)
        if loaded is not None:
            return loaded
    key = tuple(int(x) for x in sizes)
    if key not in _GENERATED:
        n_slabs = {0: 7, 1: 7, 2: 6}
        _GENERATED[key] = {
            c: np.stack([generate_pst(sizes[c], s)
                         for s in range(n_slabs[c])])
            for c in range(3)}
    return {c: t.copy() for c, t in _GENERATED[key].items()}


_GENERATED: Dict[tuple, Dict[int, np.ndarray]] = {}


def slab_index_table() -> np.ndarray:
    """count_particle -> slab index within its class (derived from
    TIFF_INDEX the same way the reference's get_PST does,
    ROtracker.py:474-492)."""
    out = []
    for idx in TIFF_INDEX:
        cls = idx // 20
        num = idx - cls * 20
        out.append(num // 3)
    return np.asarray(out, np.int32)
