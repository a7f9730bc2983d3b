"""Segmentation metrics: Dice / Jaccard / 95% Hausdorff / ASD.

The reference scores with ``medpy.metric.binary`` (`utils/test_3d_patch.py:
269-275`). medpy is not vendored here; these are algorithm-faithful
reimplementations on scipy primitives (medpy's own backend): surface
distances via ``distance_transform_edt`` of the complement of the
border-eroded reference, borders from ``binary_erosion`` with a
connectivity-1 structuring element.

Also hosts the exact host-side largest-CC used at offline test time
(`getLargestCC`, `test_3d_patch.py:11-18`): scipy label (full connectivity,
the skimage default) + argmax bincount.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _as_bool(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x).astype(bool))


def dice_binary(result, reference) -> float:
    """medpy ``dc``: 2|A.B| / (|A|+|B|)."""
    result, reference = _as_bool(result), _as_bool(reference)
    inter = np.count_nonzero(result & reference)
    size = np.count_nonzero(result) + np.count_nonzero(reference)
    if size == 0:
        return 0.0
    return 2.0 * inter / size


def jaccard_binary(result, reference) -> float:
    """medpy ``jc``: |A.B| / |A+B|."""
    result, reference = _as_bool(result), _as_bool(reference)
    inter = np.count_nonzero(result & reference)
    union = np.count_nonzero(result | reference)
    if union == 0:
        return 0.0
    return inter / union


# Above this many border voxels a full-volume EDT beats the KD-tree
# (O(V) with a small constant vs O(P log P)); typical anatomical borders
# are a few thousand voxels, far below it.
_KDTREE_MAX_PTS = 200_000


def _surface_distances(result, reference, voxelspacing=None,
                       connectivity: int = 1) -> np.ndarray:
    """medpy ``__surface_distances``: distances from result-border voxels
    to the reference border.

    medpy samples ``distance_transform_edt(~reference_border)`` at the
    result border; for each border voxel that is by definition the exact
    Euclidean distance to its nearest reference-border voxel, so a
    KD-tree nearest-neighbour query over the (sparse) border point sets
    returns the same float64 values without the O(volume) transform —
    the training-validation host path is dominated by this kernel
    (ACDC: 3 classes x 2 directions x 20 volumes per sweep,
    `val_2d.py:30-37`). Dense borders fall back to the EDT."""
    result, reference = _as_bool(result), _as_bool(reference)
    if not result.any() or not reference.any():
        raise ValueError("surface distances need non-empty masks")
    footprint = ndimage.generate_binary_structure(result.ndim, connectivity)
    result_border = result ^ ndimage.binary_erosion(
        result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(
        reference, structure=footprint, iterations=1)
    r_pts = np.argwhere(result_border)
    ref_pts = np.argwhere(reference_border)
    if len(r_pts) + len(ref_pts) > _KDTREE_MAX_PTS:
        dt = ndimage.distance_transform_edt(~reference_border,
                                            sampling=voxelspacing)
        return dt[result_border]
    if voxelspacing is not None:
        sp = np.asarray(voxelspacing, dtype=np.float64)
        if sp.ndim == 0:
            sp = np.full(result.ndim, float(sp))
        r_pts = r_pts * sp
        ref_pts = ref_pts * sp
    from scipy.spatial import cKDTree
    d, _ = cKDTree(ref_pts).query(r_pts, k=1)
    return np.asarray(d, dtype=np.float64)


def hd95(result, reference, voxelspacing=None) -> float:
    """medpy ``hd95``: 95th percentile of the symmetric surface
    distances."""
    d1 = _surface_distances(result, reference, voxelspacing)
    d2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(result, reference, voxelspacing=None) -> float:
    """medpy ``asd``: mean result->reference surface distance
    (asymmetric, exactly like the reference's calls)."""
    return float(_surface_distances(result, reference, voxelspacing).mean())


def calculate_metric_percase(pred, gt) -> Tuple[float, float, float, float]:
    """(dice, jaccard, hd95, asd) — `test_3d_patch.py:269-275`."""
    return (dice_binary(pred, gt), jaccard_binary(pred, gt),
            hd95(pred, gt), asd(pred, gt))


def calculate_dice_hd95(pred, gt) -> Tuple[float, float]:
    """(dice, hd95) with the zero-pred guard — `val_2d.py:9-17`.

    Also guards an empty *ground truth* (the reference would crash inside
    medpy there; returning (dice, 0) keeps early-training validation
    alive — a deliberate robustness divergence)."""
    pred = _as_bool(pred)
    gt = _as_bool(gt)
    if pred.sum() == 0:
        return 0.0, 0.0
    if gt.sum() == 0:
        return dice_binary(pred, gt), 0.0
    return dice_binary(pred, gt), hd95(pred, gt)


def host_largest_cc(segmentation: np.ndarray,
                    connectivity: Optional[int] = None) -> np.ndarray:
    """Exact offline LCC — `getLargestCC` (`test_3d_patch.py:11-18`).
    skimage's default connectivity is full (ndim)."""
    seg = np.asarray(segmentation)
    ndim = seg.ndim
    conn = ndim if connectivity is None else connectivity
    structure = ndimage.generate_binary_structure(ndim, conn)
    labels, num = ndimage.label(seg, structure=structure)
    if num == 0:
        return seg
    counts = np.bincount(labels.ravel())
    best = np.argmax(counts[1:]) + 1
    return labels == best
