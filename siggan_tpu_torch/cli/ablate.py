"""Ablation study CLI: the JAX package's flags on the port.

Usage:
    python -m siggan_tpu_torch.cli.ablate --data_dir DIR \
        [--output_dir ./ablation_results] [--epochs 20] [--latent_dims 50 100 200] \
        [--activations relu leaky_relu] [--spectral_norm off on] [--no_fid] \
        [--device cuda]

Runs the latent x activation x spectral-norm grid (``train/ablation.py``) on
the 64 px images of ``--data_dir`` (any of the JAX package's image files)
and writes ``results.csv``, ``results.md``, ``results.json``, ``plots.json``
(the points of the five plots) and ``samples/<short_name>.png``. Runs on the
card; ``--device cpu`` runs the same code on the CPU, and without a card
the default raises.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run the GAN ablation grid")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./ablation_results")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--latent_dims", type=int, nargs="+", default=[50, 100, 200])
    p.add_argument("--activations", type=str, nargs="+", default=["relu", "leaky_relu"])
    p.add_argument("--spectral_norm", type=str, nargs="+", default=["off", "on"],
                   choices=["off", "on"])
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)

    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.train.ablation import AblationStudyManager

    ds = SignatureDataset(args.data_dir, 64, max_images=args.max_images)
    mgr = AblationStudyManager(ds.images, args.output_dir, epochs=args.epochs,
                               batch_size=args.batch_size, seed=args.seed, device=device)
    overrides = {
        "latent_dim": args.latent_dims,
        "g_activation": args.activations,
        "use_spectral_norm": [s == "on" for s in args.spectral_norm],
    }
    results = mgr.run_all(overrides, compute_fid=not args.no_fid)
    print(f"{len(results)} runs complete -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
