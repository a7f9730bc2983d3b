"""Training-time statistics helpers for the port: ``bcp_tpu/utils/
statistic.py`` (reference `pancreas/statistic.py:7-214`,
`utils/metrics.py:13-46`), numpy only. The port imports nothing of the JAX
package, so it keeps this copy; ``tests/test_torch_statistic.py`` holds it
to the JAX package's module on the same arrays.
"""

from __future__ import annotations

import numpy as np


def _flat(x):
    return np.asarray(x).reshape(-1).astype(np.float64)


def dice_ratio(masks, labels) -> float:
    """Global binary dice with +1e-6 smoothing —
    `pancreas/statistic.py:28-43`."""
    m1, m2 = _flat(masks), _flat(labels)
    inter = (m1 * m2).sum()
    return float(2.0 * inter / (m1.sum() + m2.sum() + 1e-6))


def dice_loss_score(masks, labels, is_average: bool = True):
    """Per-sample dice score with +1.0 smoothing —
    `pancreas/statistic.py:7-25`."""
    m = np.asarray(masks).reshape(len(masks), -1).astype(np.float64)
    l = np.asarray(labels).reshape(len(labels), -1).astype(np.float64)
    inter = (m * l).sum(axis=1)
    score = 2.0 * inter / (m.sum(axis=1) + l.sum(axis=1) + 1.0)
    return float(score.mean()) if is_average else score


def cal_dice(prediction, label, num: int = 2) -> np.ndarray:
    """Per-class dice vector over classes 1..num-1 —
    `utils/metrics.py:13-24`."""
    out = np.zeros(num - 1)
    for i in range(1, num):
        p = (np.asarray(prediction) == i).astype(np.float64)
        g = (np.asarray(label) == i).astype(np.float64)
        denom = p.sum() + g.sum()
        out[i - 1] = 2.0 * (p * g).sum() / denom if denom > 0 else 0.0
    return out


def smooth_dice(input_mask, target, ignore_index=None) -> float:
    """Laplace-smoothed (+1) global dice — `utils/metrics.py:36-46`."""
    iflat, tflat = _flat(input_mask), _flat(target).copy()
    if ignore_index is not None:
        sel = tflat == ignore_index
        tflat[sel] = 0
        iflat = iflat.copy()
        iflat[sel] = 0
    inter = (iflat * tflat).sum()
    return float((2.0 * inter + 1.0) / (iflat.sum() + tflat.sum() + 1.0))


def accuracy(pred, gt) -> float:
    pred, gt = np.asarray(pred), np.asarray(gt)
    return float((pred == gt).mean())


def precision_recall(pred, gt):
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    tp = float(np.count_nonzero(pred & gt))
    p = tp / max(float(np.count_nonzero(pred)), 1e-8)
    r = tp / max(float(np.count_nonzero(gt)), 1e-8)
    return p, r


# ---------------------------------------------------------------------------
# the library tail (unused by the pipelines, kept for component parity)

def dice_mc(masks, labels, classes: int):
    """Multi-class dice with *cumulative* cross-sample totals —
    `pancreas/statistic.py:46-74`. Returns ``(aver_dice, per_class_dice)``.

    Faithful to the reference's quirks: ``class_dice[i]`` is computed from
    intersection/pred/label totals accumulated over samples ``0..i`` (the
    running sums are initialised once outside the sample loop), classes
    absent from a sample's label are skipped, and the per-class average
    divides by the count of samples that contained the class (+1e-5).
    """
    masks = np.asarray(masks)
    labels = np.asarray(labels)
    num = labels.shape[0]
    class_dice = np.zeros(num)
    per_class_dice = np.zeros((num, classes))
    per_class_cnt = np.zeros((num, classes))
    tot_i = tot_p = tot_l = 0.0
    for i in range(num):
        for n in range(1, classes):
            if (labels[i] == n).sum():
                pred = masks[i] == n
                labs = labels[i] == n
                inter = float((pred & labs).sum())
                per_class_dice[i, n - 1] = (
                    2.0 * inter / (float(pred.sum()) + float(labs.sum())))
                per_class_cnt[i, n - 1] += 1
                tot_i += inter
                tot_p += float(pred.sum())
                tot_l += float(labs.sum())
        class_dice[i] = 2.0 * tot_i / (tot_p + tot_l)
    aver = float(class_dice.sum() / num)
    per_class = per_class_dice.sum(0) / (per_class_cnt.sum(0) + 1e-5)
    return aver, per_class


def dice_m(masks, labels, classes: int):
    """Per-sample multi-class dice — `pancreas/statistic.py:77-104`.
    Returns ``(class_dice, per_class_dice)``; the reference's per-pixel
    python loop is replaced by vectorised per-class counts (identical
    arithmetic: intersection counts pixels where pred == label == c).
    Classes with no pred and no label pixels yield NaN per-class entries
    (the reference's 0/0), which propagate into the per-class average."""
    masks = np.asarray(masks).reshape(len(masks), -1)
    labels = np.asarray(labels).reshape(len(labels), -1)
    num = masks.shape[0]
    class_dice = np.zeros(num)
    per_class = np.zeros((num, classes))
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(num):
            m1c = np.array([(masks[i] == c).sum()
                            for c in range(1, classes + 1)], np.float64)
            m2c = np.array([(labels[i] == c).sum()
                            for c in range(1, classes + 1)], np.float64)
            ic = np.array([((masks[i] == c) & (labels[i] == c)).sum()
                           for c in range(1, classes + 1)], np.float64)
            per_class[i] = 2.0 * ic / (m1c + m2c)
            class_dice[i] = 2.0 * ic.sum() / (m1c.sum() + m2c.sum())
    return float(class_dice.sum() / num), per_class.sum(0) / num


def hausdorff_mad_distance(set1, set2, max_ahd=np.inf):
    """Symmetric Hausdorff distance between two point sets by pairwise
    euclidean distances — `pancreas/statistic.py:106-139` (despite the
    name and docstring it returns only the max-of-min-distances HD;
    ``max_ahd`` is returned when either set is empty)."""
    if len(set1) == 0 or len(set2) == 0:
        return max_ahd
    set1 = np.asarray(set1, np.float64)
    set2 = np.asarray(set2, np.float64)
    assert set1.ndim == 2 and set2.ndim == 2
    assert set1.shape[1] == set2.shape[1]
    from scipy.spatial.distance import cdist
    d = cdist(set1, set2, metric="euclidean")
    d12 = d.min(axis=0)
    d21 = d.min(axis=1)
    return float(max(d12.max(), d21.max(), 0.0))


def acc(masks, labels):
    """Pixel accuracy triple — `pancreas/statistic.py:140-148`:
    ``(accuracy, n_same, n_total)``."""
    m1 = np.asarray(masks).reshape(-1)
    m2 = np.asarray(labels).reshape(-1)
    same = float((m1 == m2).sum())
    return same / m2.size, same, m2.size


def acc_test(masks, labels, masks_con):
    """Accuracy/dice of a *second* mask restricted to pixels the first
    mask left background — `pancreas/statistic.py:151-173`. Returns
    ``(n_same, dice, n_same_bg, n_same_fg, n_miss_fg, n_miss_bg, n)``
    (the reference returns the raw agreement count in the ``acc`` slot)."""
    sel = np.asarray(masks).reshape(-1) == 0
    m1 = np.asarray(masks_con).reshape(-1)[sel].astype(np.float64)
    m2 = np.asarray(labels).reshape(-1)[sel].astype(np.float64)
    same = float((m1 == m2).sum())
    inter = float((m1 * m2).sum())
    dice = 2.0 * inter / (m1.sum() + m2.sum() + 1.0)
    mis0 = float(((m1 != m2) & (m2 == 1)).sum())
    mis1 = float(((m1 != m2) & (m2 == 0)).sum())
    return same, dice, same - inter, inter, mis0, mis1, int(m1.size)


def acc_m(masks, labels, masks_con):
    """`pancreas/statistic.py:176-196`: like :func:`acc_test` but the
    agreeing-foreground/background counts are returned as *fractions* of
    all agreeing pixels. Returns ``(n_same, dice, frac_bg, frac_fg)``."""
    sel = np.asarray(masks).reshape(-1) == 0
    m1 = np.asarray(masks_con).reshape(-1)[sel].astype(np.float64)
    m2 = np.asarray(labels).reshape(-1)[sel].astype(np.float64)
    same = float((m1 == m2).sum())
    inter = float((m1 * m2).sum())
    dice = 2.0 * inter / (m1.sum() + m2.sum() + 1.0)
    return same, dice, (same - inter) / same, inter / same


def pre_rec(masks, labels):
    """Binary precision/recall with +1e-6 smoothing —
    `pancreas/statistic.py:199-214`."""
    m1 = _flat(masks)
    m2 = _flat(labels)
    inter = (m1 * m2).sum()
    return (float(inter / (m1.sum() + 1e-6)),
            float(inter / (m2.sum() + 1e-6)))
