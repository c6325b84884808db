"""Verifier evaluation: scoring, the curves' points, the comparison report.

Port of the JAX package's ``verify/eval.py``: batched similarity scoring of
seeded test pairs on the device, ``compute_verification_metrics`` per
model, a JSON report with the baseline-against-augmented improvement
percentages, and a console comparison table. The JAX package draws four
matplotlib plots (ROC, log-log DET, score distributions with the EER
threshold, metric bars); the port writes the points behind them to
``curves.json`` beside the report instead, for any plotting tool: per
model the ROC ``fpr``/``tpr``/``thresholds`` (a non-finite threshold as
null), the DET ``fpr``/``fnr`` where both are > 0 (the plot's log axes),
30-bin density histograms of the genuine and forgery scores with the EER
threshold, and the bars' metric values.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

from siggan_tpu_torch.core.platform import DeviceLike
from siggan_tpu_torch.verify.metrics import (compute_verification_metrics,
                                             det_points, roc_points)
from siggan_tpu_torch.verify.train import (load_verifier, model_from_snapshot,
                                           predict_scores)

HIGHER_BETTER = {"accuracy", "roc_auc", "f1_score", "precision", "recall",
                 "specificity"}
BAR_KEYS = ("accuracy", "far", "frr", "eer", "roc_auc", "f1_score")


def evaluate_model(snapshot: Dict, test_data, batch_size: int = 128,
                   threshold: float = 0.5, device: DeviceLike = "cuda") -> Dict[str, Any]:
    img1, img2, labels = test_data
    model = model_from_snapshot(snapshot, device)
    scores = predict_scores(model, img1, img2, batch_size)
    preds = (scores > threshold).astype(np.float32)
    metrics = compute_verification_metrics(labels, scores, preds, threshold)
    return {"metrics": metrics, "y_true": labels, "y_scores": scores,
            "metadata": {k: snapshot[k] for k in ("epoch", "val_accuracy")
                         if k in snapshot}}


# -- the plots' points ------------------------------------------------------

def _finite_or_none(a: np.ndarray) -> list:
    return [float(v) if np.isfinite(v) else None for v in np.asarray(a, np.float64)]


def curve_points(results: Dict[str, Dict]) -> Dict[str, Any]:
    """The data of the ROC, DET, score-distribution and metric-bar plots."""
    out: Dict[str, Any] = {"models": {}, "bars": {
        "keys": list(BAR_KEYS),
        "values": {n: [r["metrics"][k] for k in BAR_KEYS] for n, r in results.items()}}}
    for name, r in results.items():
        y, s = np.asarray(r["y_true"]), np.asarray(r["y_scores"])
        fpr, tpr, thr = roc_points(y, s)
        dfpr, dfnr = det_points(y, s)
        m = (dfpr > 0) & (dfnr > 0)
        hist = {}
        for label, sel in (("genuine", y == 1), ("forgery", y == 0)):
            dens, edges = (np.histogram(s[sel], bins=30, density=True) if sel.any()
                           else (np.zeros(0), np.zeros(0)))
            hist[label] = {"density": _finite_or_none(dens), "edges": _finite_or_none(edges)}
        out["models"][name] = {
            "roc": {"fpr": _finite_or_none(fpr), "tpr": _finite_or_none(tpr),
                    "thresholds": _finite_or_none(thr),
                    "auc": r["metrics"]["roc_auc"]},
            "det": {"fpr": _finite_or_none(dfpr[m]), "fnr": _finite_or_none(dfnr[m])},
            "scores": {**hist, "eer_threshold": r["metrics"]["eer_threshold"]},
        }
    return out


def write_curves(results: Dict[str, Dict], path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(curve_points(results), indent=1))
    return path


# -- report -----------------------------------------------------------------

def generate_evaluation_report(results: Dict[str, Dict],
                               output_path: str | Path) -> Dict[str, Any]:
    report: Dict[str, Any] = {
        "evaluation_timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "num_models_evaluated": len(results),
        "models": {},
    }
    for name, data in results.items():
        report["models"][name] = {
            "model_metadata": data.get("metadata", {}),
            "metrics": data["metrics"],
            "num_test_samples": int(len(data["y_true"])),
            "genuine_samples": int(np.sum(data["y_true"] == 1)),
            "forgery_samples": int(np.sum(data["y_true"] == 0)),
        }
    if len(results) > 1:
        comparison: Dict[str, Any] = {}
        for metric in BAR_KEYS:
            values = {n: d["metrics"][metric] for n, d in results.items()}
            pick = max if metric in HIGHER_BETTER else min
            comparison[metric] = {
                "values": values,
                "best_model": pick(values, key=values.get),
                "improvement": None,
            }
            if "baseline" in values and "augmented" in values:
                b, a = values["baseline"], values["augmented"]
                if metric in HIGHER_BETTER:
                    imp = (a - b) / b * 100 if b else None
                else:
                    imp = (b - a) / b * 100 if b else None
                comparison[metric]["improvement"] = (
                    round(imp, 2) if imp is not None else None)
        report["comparison"] = comparison
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, default=_jsonable))
    return report


def _jsonable(o):
    """numpy scalars/arrays from checkpoint metadata -> plain python."""
    if isinstance(o, np.ndarray):
        return o.item() if o.ndim == 0 else o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def print_comparison_table(results: Dict[str, Dict]) -> None:
    names = list(results.keys())
    print("=" * 70)
    print(f"{'metric':<14}" + "".join(f"{n:>14}" for n in names))
    print("-" * 70)
    for k in BAR_KEYS:
        row = f"{k:<14}"
        for n in names:
            row += f"{results[n]['metrics'][k]:>14.4f}"
        print(row)
    print("=" * 70)


def evaluate_signature_verifier(model_paths: Dict[str, str], test_data,
                                output_dir: str | Path,
                                batch_size: int = 128,
                                threshold: float = 0.5,
                                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Load each model, score the seeded test pairs, write
    ``evaluation_report.json`` and ``curves.json``, print the table."""
    out = Path(output_dir)
    results = {}
    for name, path in model_paths.items():
        snapshot = load_verifier(path)
        results[name] = evaluate_model(snapshot, test_data, batch_size,
                                       threshold, device)
        print(f"[{name}] acc {results[name]['metrics']['accuracy']:.4f} "
              f"EER {results[name]['metrics']['eer']:.4f}", flush=True)
    write_curves(results, out / "curves.json")
    report = generate_evaluation_report(results, out / "evaluation_report.json")
    print_comparison_table(results)
    return report
