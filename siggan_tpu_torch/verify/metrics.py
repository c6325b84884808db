"""Verification metrics: accuracy, FAR, FRR, EER, ROC-AUC, DET inputs.

Port of the JAX package's ``verify/metrics.py`` with the same keys and
formulas: FAR = FP/(FP+TN), FRR = FN/(FN+TP), the EER at
``nanargmin|FPR - FNR|`` over the ROC curve's points, precision, recall,
F1, specificity and the confusion counts. The JAX module calls sklearn;
the port keeps its own numpy copy of what it uses: ``roc_curve`` as
sklearn >= 1.3 computes it (thresholds at the distinct scores in
descending order, ``drop_intermediate=True``'s removal of collinear
points, a prepended ``inf`` threshold at (0, 0), NaN rates for a class
that is absent), ``auc`` (the trapezoid rule) and the 2 x 2 confusion
counts, so the EER is taken over exactly sklearn's points.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2 has only trapz


def roc_curve(y_true: np.ndarray, y_scores: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of binary labels (1 = positive) against scores,
    sklearn's ``roc_curve(y_true, y_scores)``."""
    y = np.asarray(y_true).ravel() == 1
    s = np.asarray(y_scores).ravel()
    if len(y) != len(s):
        raise ValueError(f"{len(y)} labels against {len(s)} scores")
    if not np.all(np.isfinite(s)):
        raise ValueError("scores must be finite")
    order = np.argsort(-s, kind="stable")   # descending, ties in input order
    s, y = s[order], y[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(s))[0], len(y) - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = s[idx]
    if len(fps) > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless")
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless")
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Area under the curve (x, y) by the trapezoid rule; x monotonic."""
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * _trapezoid(y, x))


def confusion_counts(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[int, int, int, int]:
    """(tn, fp, fn, tp) of binary labels and predictions."""
    t = np.asarray(y_true).ravel() == 1
    p = np.asarray(y_pred).ravel() == 1
    return (int(np.sum(~t & ~p)), int(np.sum(~t & p)), int(np.sum(t & ~p)),
            int(np.sum(t & p)))


def _eer(y_true, y_scores):
    fpr, tpr, thresholds = roc_curve(y_true, y_scores)
    fnr = 1 - tpr
    eer_idx = int(np.nanargmin(np.abs(fpr - fnr)))
    return fpr, tpr, thresholds, (fpr[eer_idx] + fnr[eer_idx]) / 2, eer_idx


def compute_verification_metrics(y_true: np.ndarray, y_scores: np.ndarray,
                                 y_pred: np.ndarray, threshold: float = 0.5
                                 ) -> Dict[str, float]:
    accuracy = float(np.mean(np.asarray(y_true).ravel() == np.asarray(y_pred).ravel()))
    tn, fp, fn, tp = confusion_counts(y_true, y_pred)

    total_forgeries = fp + tn
    far = fp / total_forgeries if total_forgeries > 0 else 0.0
    total_genuine = fn + tp
    frr = fn / total_genuine if total_genuine > 0 else 0.0
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    specificity = tn / (tn + fp) if (tn + fp) > 0 else 0.0

    fpr, tpr, roc_thresholds, eer, eer_idx = _eer(y_true, y_scores)
    roc_auc = auc(fpr, tpr)
    eer_threshold = (roc_thresholds[eer_idx]
                     if len(roc_thresholds) > eer_idx else threshold)
    if not np.isfinite(eer_threshold):
        # A constant-score verifier lands the EER on the prepended inf
        # threshold, which is not valid JSON: report the largest finite one.
        finite = roc_thresholds[np.isfinite(roc_thresholds)]
        eer_threshold = float(finite.max()) if len(finite) else float(threshold)

    return {
        "accuracy": float(accuracy),
        "far": float(far),
        "frr": float(frr),
        "eer": float(eer),
        "eer_threshold": float(eer_threshold),
        "precision": float(precision),
        "recall": float(recall),
        "f1_score": float(f1),
        "specificity": float(specificity),
        "roc_auc": float(roc_auc),
        "true_positives": int(tp),
        "true_negatives": int(tn),
        "false_positives": int(fp),
        "false_negatives": int(fn),
        "total_genuine": int(total_genuine),
        "total_forgeries": int(total_forgeries),
        "threshold": float(threshold),
    }


def compute_eer_from_scores(y_true: np.ndarray, y_scores: np.ndarray
                            ) -> Tuple[float, float]:
    _, _, thresholds, eer, eer_idx = _eer(y_true, y_scores)
    eer_threshold = thresholds[eer_idx] if len(thresholds) > eer_idx else 0.5
    return float(eer), float(eer_threshold)


def roc_points(y_true: np.ndarray, y_scores: np.ndarray):
    return roc_curve(y_true, y_scores)


def det_points(y_true: np.ndarray, y_scores: np.ndarray):
    """(FPR, FNR) pairs for log-log DET plotting."""
    fpr, tpr, _ = roc_curve(y_true, y_scores)
    return fpr, 1 - tpr
