"""Verifier evaluation CLI: the JAX package's flags on the port.

Usage:
    python -m siggan_tpu_torch.cli.verifier_eval --data_dir REAL \
        --baseline_model verifier_baseline.pkl \
        [--augmented_model verifier_augmented.pkl] \
        [--output_dir ./verifier_evaluation] [--device cuda]

Port of ``siggan_tpu/cli/verifier_eval.py``: scores seeded test pairs with
each verifier checkpoint (either package's pickle) and writes
``evaluation_report.json`` (FAR/FRR/EER/ROC-AUC..., the comparison with
improvement %) and ``curves.json`` (the points of the ROC, DET,
score-distribution and metric-bar plots, which the port does not draw).
It runs on the card (``--device cpu`` for tests) and raises without one.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate signature verifiers")
    p.add_argument("--data_dir", type=str, required=True,
                   help="real signatures for test pair generation")
    p.add_argument("--baseline_model", type=str, required=True)
    p.add_argument("--augmented_model", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="./verifier_evaluation")
    p.add_argument("--pairs_per_user", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=123,
                   help="test pairs are seeded for reproducibility")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="decision threshold on the similarity score")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)

    from siggan_tpu_torch.verify.eval import evaluate_signature_verifier
    from siggan_tpu_torch.verify.pairs import PairDataset

    ds = PairDataset(args.data_dir, pairs_per_user=args.pairs_per_user,
                     seed=args.seed)
    print(f"Test pairs: {ds.summary()}", flush=True)
    test_data = (ds.img1, ds.img2, ds.labels)

    model_paths = {"baseline": args.baseline_model}
    if args.augmented_model:
        model_paths["augmented"] = args.augmented_model
    evaluate_signature_verifier(model_paths, test_data, args.output_dir,
                                args.batch_size, args.threshold, device)
    print(f"Outputs in {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
