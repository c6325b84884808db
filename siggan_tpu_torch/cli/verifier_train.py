"""Verifier training CLI: the JAX package's flags on the port.

Usage:
    python -m siggan_tpu_torch.cli.verifier_train --data_dir REAL \
        [--synthetic_dir GENERATED] [--output_dir ./verifier_models] \
        [--epochs 20] [--batch_size 32] [--device cuda]

Port of ``siggan_tpu/cli/verifier_train.py``: trains a baseline (real
pairs only) and, with ``--synthetic_dir``, an augmented (real + synthetic
impostors) Siamese verifier, writing ``verifier_baseline.pkl``,
``verifier_augmented.pkl`` and ``training_history.json``. It runs on the
card (``--device cpu`` runs the same code on the CPU, for tests) and
raises without one.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Train Siamese signature verifiers (baseline vs augmented)")
    p.add_argument("--data_dir", type=str, required=True,
                   help="real signatures (per-user subdirs or prefixed files)")
    p.add_argument("--synthetic_dir", type=str, default=None,
                   help="GAN-generated signatures for the augmented model")
    p.add_argument("--output_dir", type=str, default="./verifier_models")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pairs_per_user", type=int, default=10)
    p.add_argument("--embedding_dim", type=int, default=128,
                   help="Siamese embedding size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)

    from siggan_tpu_torch.verify.train import train_model

    results = train_model(
        args.data_dir, args.synthetic_dir, args.output_dir,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        pairs_per_user=args.pairs_per_user, seed=args.seed,
        embedding_dim=args.embedding_dim, device=device)
    for name, r in results.items():
        print(f"{name}: best val accuracy {r['best_val_accuracy']:.4f} "
              f"({r['steps']} steps in {r['seconds']:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
