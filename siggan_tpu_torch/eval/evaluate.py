"""Evaluation orchestrator: FID / KID / precision-recall, LPIPS and stroke
stats, each metric's failure captured.

Port of the JAX package's ``eval/evaluate.py:21-161`` (``compute_metrics``,
``save_evaluation_report``, ``print_summary``), line for line in
behaviour: each metric's exception is recorded under ``errors`` and the
report goes on (one broken metric never kills the report), LPIPS runs on a
``lpips_subset`` of the fakes, a trained backbone adds its real-vs-real
floor and feature diversity. The networks run on ``device`` (the card by
default).
"""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np

from siggan_tpu_torch.core.platform import DeviceLike, resolve_device


def compute_metrics(real: np.ndarray, fake: np.ndarray, *,
                    lpips_subset: int = 100,
                    inception_params: Optional[Mapping] = None,
                    lpips_params: Optional[Mapping] = None,
                    lpips_backbone: str | None = None,
                    fid_backbone: str = "random-init",
                    scorer=None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Both inputs (N, H, W, 1) float32 in [-1, 1].

    ``inception_params``: a torchvision InceptionV3 state dict (tagged
    "torchvision"); otherwise ``fid_backbone`` is a spec for
    ``eval.fid.make_scorer``. A trained backbone (``verifier:``, ROADMAP
    A.7) also reports the split-half real-vs-real floor and a feature-space
    diversity.

    ``lpips_params``: an ``LPIPS`` state dict; ``lpips_backbone`` is its
    provenance label, which the caller must give ("torchvision",
    "random-init", ...): it is never inferred from the params' presence,
    and params without a label record "caller-supplied (unspecified)".

    ``scorer``: an already-built ``FIDScorer`` to reuse across calls; it
    overrides the other FID backbone arguments."""
    from siggan_tpu_torch.eval import lpips as lpips_mod
    from siggan_tpu_torch.eval.fid import (FIDScorer, feature_diversity,
                                           frechet_distance, kernel_distance,
                                           make_scorer, precision_recall)
    from siggan_tpu_torch.eval.stroke import (calculate_foreground_ratio,
                                              calculate_stroke_density)

    results: Dict[str, Any] = {"errors": {}}

    try:
        if scorer is None:
            scorer = (FIDScorer(inception_params, device=device)
                      if inception_params is not None
                      else make_scorer(fid_backbone, device=device))
        fr, ff = scorer._conditioned_features(real, fake)
        results["fid"] = frechet_distance(fr, ff)
        # KID (unbiased MMD^2, cubic kernel): FID's companion, unbiased at
        # any sample count.
        n_min = min(len(fr), len(ff))
        if n_min >= 2:
            kid = kernel_distance(fr, ff)
            results["kid_mean"], results["kid_std"] = kid["mean"], kid["std"]
        if n_min >= 4:     # k-NN manifolds need > k (=3) samples per set
            # Fidelity / coverage, capped for the O(n^2) distance matrices.
            n_pr = min(n_min, 1024)
            results.update(precision_recall(fr[:n_pr], ff[:n_pr]))
        results["fid_backbone"] = scorer.backbone
        if scorer.backbone.startswith("verifier:"):
            half = len(real) // 2
            if half >= 8:
                results["fid_real_floor"] = scorer.fid(real[:half], real[half:])
            results["feature_diversity"] = {
                "fake": feature_diversity(scorer, fake[:lpips_subset]),
                "real": feature_diversity(scorer, real[:lpips_subset]),
            }
    except Exception as e:
        results["errors"]["fid"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()

    try:
        model = (lpips_mod.init_lpips() if lpips_params is None
                 else lpips_mod.from_state_dict(lpips_params))
        results["lpips_diversity"] = lpips_mod.diversity(
            model.to(resolve_device(device)), fake[:lpips_subset])
        if lpips_params is None:
            results["lpips_backbone"] = "random-init"
        else:
            results["lpips_backbone"] = (
                lpips_backbone or "caller-supplied (unspecified)")
    except Exception as e:
        results["errors"]["lpips"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()

    try:
        results["stroke_density"] = {
            "fake": calculate_stroke_density(fake, device=device),
            "real": calculate_stroke_density(real, device=device),
        }
        results["foreground_ratio"] = {
            "fake": calculate_foreground_ratio(fake, device=device),
            "real": calculate_foreground_ratio(real, device=device),
        }
    except Exception as e:
        results["errors"]["stroke_stats"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()

    return results


def save_evaluation_report(results: Dict[str, Any], path: str | Path,
                           extra: Optional[Dict[str, Any]] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    report = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        **(extra or {}),
        "metrics": results,
    }
    path.write_text(json.dumps(report, indent=2))
    return path


def print_summary(results: Dict[str, Any]) -> None:
    print("=" * 60)
    print("EVALUATION SUMMARY")
    print("=" * 60)
    if "fid" in results:
        if results.get("fid_backbone") == "torchvision":
            verdict = ("excellent" if results["fid"] < 30 else
                       "good" if results["fid"] < 50 else
                       "fair" if results["fid"] < 80 else "poor")
            print(f"FID: {results['fid']:.2f} ({verdict})")
        else:
            # A random-backbone FID is a relative metric; the <50-good bands
            # apply only to torchvision features.
            print(f"FID: {results['fid']:.2f} "
                  f"[backbone: {results.get('fid_backbone')} — relative "
                  f"metric, compare against controls, not absolute bands]")
    if "kid_mean" in results:
        print(f"KID: {results['kid_mean']:.4g} ± {results['kid_std']:.2g} "
              f"[same backbone/conditioning as FID; unbiased at small n]")
    if "precision" in results:
        print(f"precision/recall (k-NN manifold): "
              f"{results['precision']:.3f} / {results['recall']:.3f} "
              f"[fidelity / mode coverage]")
    if "lpips_diversity" in results:
        div = ("diverse" if results["lpips_diversity"] > 0.1 else
               "low diversity — possible mode collapse")
        print(f"LPIPS diversity: {results['lpips_diversity']:.4f} ({div})")
    for key in ("stroke_density", "foreground_ratio"):
        if key in results:
            f, r = results[key]["fake"], results[key]["real"]
            print(f"{key}: fake {f['mean']:.4f}±{f['std']:.4f} "
                  f"vs real {r['mean']:.4f}±{r['std']:.4f}")
    if results.get("errors"):
        print(f"errors: {results['errors']}")
    print("=" * 60)
