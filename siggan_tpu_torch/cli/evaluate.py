"""Evaluation CLI: the JAX package's flags on the port.

Usage:
    python -m siggan_tpu_torch.cli.evaluate --checkpoint DIR --data_dir PNGS \
        [--which latest|best|N] [--n_samples 500] [--seeds 0 1 2] [--device cuda]

Port of ``siggan_tpu/cli/evaluate.py:15-143``: load a checkpoint (a
generator checkpoint, or the epoch ``--which`` names in a run directory),
generate ``--n_samples`` per seed (through kernel B4 for a ``use_pallas``
64 px ReLU checkpoint), load the real PNGs, compute FID / KID /
precision-recall / LPIPS / stroke stats per seed (mean and std over
``--seeds``), write the sample grids and ``evaluation_report.json``, and
print a summary. It runs on the card (``--device cpu`` runs the same code
on the CPU, for tests) and raises without one.

``--backbone random-init`` (the default) is the port's own fixed-seed
random InceptionV3, so its FIDs compare within the port only; to compare
with the JAX package, score both with one weight file
(``--inception_weights`` or ``--backbone torchvision:<file>``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate a signature GAN checkpoint "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--which", type=str, default="latest")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory of real (preprocessed) images")
    p.add_argument("--n_samples", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="multi-seed protocol: evaluate each seed and report "
                        "mean±std (GAN metrics are seed-sensitive)")
    p.add_argument("--output_dir", type=str, default="./evaluation")
    p.add_argument("--lpips_subset", type=int, default=100)
    p.add_argument("--n_grids", type=int, default=3,
                   help="sample grids to write for visual inspection")
    p.add_argument("--grid_size", type=int, default=64,
                   help="samples per grid")
    p.add_argument("--max_real", type=int, default=None)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="optional torchvision inception_v3 state-dict file "
                        "(.pt/.npz) for true-FID parity")
    p.add_argument("--backbone", type=str, default="random-init",
                   help="FID feature backbone: 'random-init' | "
                        "'torchvision:<state_dict.pt>' | "
                        "'verifier:<ckpt.pkl>' (a verifier_train checkpoint)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)
    which = args.which if args.which in ("latest", "best") else int(args.which)
    out = Path(args.output_dir)

    import numpy as np

    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.eval.evaluate import (compute_metrics, print_summary,
                                                save_evaluation_report)
    from siggan_tpu_torch.infer.export import contact_sheet
    from siggan_tpu_torch.infer.generate import load_session
    from siggan_tpu_torch.utils.visualizer import save_sample_grid

    session = load_session(args.checkpoint, which, device)
    real_ds = SignatureDataset(args.data_dir, session.cfg.image_size,
                               max_images=args.max_real)
    real = real_ds.images
    print(f"Real set: {len(real)} images", flush=True)

    inception_params = None
    if args.inception_weights:
        if args.backbone != "random-init":
            # compute_metrics would prefer inception_params and drop the
            # explicitly requested backbone: refuse instead.
            raise SystemExit("--inception_weights and --backbone are "
                             "mutually exclusive (use "
                             "--backbone torchvision:<file> instead)")
        inception_params = _load_inception_weights(args.inception_weights)

    seeds = args.seeds or [args.seed]
    per_seed = []
    for seed in seeds:
        print(f"Generating {args.n_samples} samples (seed {seed})…", flush=True)
        fake = session.sample(args.n_samples, seed=seed, batch_size=args.batch_size)
        res = compute_metrics(real, fake, lpips_subset=args.lpips_subset,
                              inception_params=inception_params,
                              fid_backbone=args.backbone, device=device)
        res["seed"] = seed
        per_seed.append(res)
    results = per_seed[0]
    if len(per_seed) > 1:
        agg = {}
        for key in ("fid", "lpips_diversity"):
            # Each value paired with its own seed, so that a seed whose
            # metric failed does not shift the others.
            pairs = [(r["seed"], r[key]) for r in per_seed if key in r]
            if pairs:
                vals = [v for _, v in pairs]
                agg[key] = {"mean": float(np.mean(vals)),
                            "std": float(np.std(vals)),
                            "per_seed": {str(s): v for s, v in pairs}}
        results = dict(per_seed[0])
        results["multi_seed"] = agg
        print("Multi-seed:", {k: f"{v['mean']:.3f}±{v['std']:.3f}"
                              for k, v in agg.items()})
    contact_sheet(fake[:64], out / "fake_grid.png")
    contact_sheet(real[:64], out / "real_grid.png")
    # n_grids disjoint windows of the generated set (the reference's
    # create_sample_grids).
    for gi in range(args.n_grids):
        lo = gi * args.grid_size
        if lo >= len(fake):
            break
        save_sample_grid(fake[lo:lo + args.grid_size], out / f"sample_grid_{gi + 1}.png")
    report = save_evaluation_report(
        results, out / "evaluation_report.json",
        extra={"checkpoint": args.checkpoint, "which": str(which),
               "n_samples": args.n_samples, "n_real": len(real),
               "seeds": seeds})
    print_summary(results)
    print(f"Report: {report}")
    return 0


def _load_inception_weights(path: str):
    """A torchvision inception_v3 state dict from ``.npz`` or ``.pt``,
    checked against the pinned manifest."""
    from siggan_tpu_torch.eval.manifests import (INCEPTION_V3_REQUIRED,
                                                 INCEPTION_V3_SD, check_state_dict)
    if path.endswith(".npz"):
        import numpy as np
        with np.load(path) as f:
            sd = {k: f[k] for k in f.files}
    else:
        import torch
        sd = torch.load(path, map_location="cpu", weights_only=True)
    check_state_dict(sd, INCEPTION_V3_SD, required=INCEPTION_V3_REQUIRED, label=path)
    return sd


if __name__ == "__main__":
    sys.exit(main())
