"""Training CLI: the JAX package's flags on the port's trainer.

Usage:
    python -m siggan_tpu_torch.cli.train --data_dir DIR --epochs 200 \
        [--batch_size 64] [--run_dir runs/exp1] [--resume] [--device cuda]

Trains on one CUDA card (``--device cpu`` runs the same code on the CPU, for
tests); without a card it raises rather than fall back. On the card the
steps run in windows of K (the JAX trainer's ``scan_steps`` rule), each a
CUDA graph of one step replayed K times. ``--data_dir`` holds PNG images
(other image files are refused). ``--spectral_norm`` with ``--image_size
128`` trains v1.1. ``--num_classes N`` trains a conditional model on the
per-writer subdirectories of ``--data_dir`` (exactly N of them); v2.0 is

    --num_classes 8 --g_conditioning concat --spectral_norm --latent_dim 200
    --d_lr 1e-4 --g_lr 2e-4 --lr_schedule linear --diffaugment translation,cutout

and ``--ema_decay``, ``--aux_weight``, ``--lr_schedule`` and
``--diffaugment`` train as in the JAX package. Flags of features the port
does not train yet (shared fakes, FID, the profiler, several cards) are
accepted and raise ``NotImplementedError``, as does a dataset over
``resident_max_mb`` (the streaming loader).
The checkpoint directory serves with ``python -m siggan_tpu_torch.cli.serve
--checkpoint DIR`` (its latest epoch), and ``cli.generate --which`` samples
any saved epoch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the signature GAN (PyTorch/CUDA port)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=64,
                   help="batch size")
    p.add_argument("--latent_dim", type=int, default=100)
    p.add_argument("--image_size", type=int, default=64, choices=[64, 128])
    p.add_argument("--g_lr", type=float, default=2e-4)
    p.add_argument("--d_lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--label_smoothing", type=float, default=0.9)
    p.add_argument("--gradient_clip", type=float, default=None)
    p.add_argument("--n_critic", type=int, default=1)
    p.add_argument("--share_fakes", action="store_true",
                   help="fast mode with the reference ablation-trainer "
                        "semantics: one latent batch per iteration, "
                        "fakes shared between the D and G updates")
    p.add_argument("--spectral_norm", action="store_true")
    p.add_argument("--num_classes", type=int, default=0,
                   help="conditional per-writer training (v2.0): number of "
                        "writers; data_dir must contain per-writer subdirs "
                        "(0 = unconditional)")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--hflip", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--rng_impl", type=str, default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="PRNG bit generator (rbg = faster on TPU; "
                        "threefry2x32 = version-stable streams)")
    p.add_argument("--sample_interval", type=int, default=5)
    p.add_argument("--checkpoint_interval", type=int, default=10)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--sample_dir", type=str, default="./samples")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--run_dir", type=str, default=None,
                   help="redirect checkpoints/samples/logs under one directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in checkpoint_dir")
    p.add_argument("--resume_from", type=str, default=None,
                   help="'latest' | 'best' | epoch number")
    p.add_argument("--stop_file", type=str, default=None,
                   help="training stops cooperatively when this file appears")
    p.add_argument("--num_data_devices", type=int, default=-1,
                   help="-1 = all visible devices on the data axis")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default="",
                   help="capture a jax.profiler trace of one epoch here")
    p.add_argument("--fid_interval", type=int, default=0,
                   help="score a relative FID every N epochs; the 'best' "
                        "checkpoint alias then follows lowest FID (0 = off, "
                        "reference-faithful best-G-loss)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="generator weight EMA decay for eval/sampling "
                        "(e.g. 0.999; 0 = off)")
    p.add_argument("--aux_weight", type=float, default=0.0,
                   help="AC-GAN auxiliary classifier loss weight "
                        "(conditional models; adds a class head to D)")
    p.add_argument("--g_conditioning", type=str, default="full",
                   choices=["full", "bn_only", "embed_only", "concat", "none"],
                   help="how G consumes the class label (conditional models)")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "linear", "cosine"],
                   help="LR decay over the second half of training")
    p.add_argument("--diffaugment", type=str, default="",
                   help="DiffAugment policy on D inputs, e.g. "
                        "'color,translation,cutout' ('' = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace):
    from siggan_tpu_torch.core.config import (MeshConfig, ModelConfig, OptimConfig,
                                        TrainConfig)

    ckpt, sample, log = args.checkpoint_dir, args.sample_dir, args.log_dir
    if args.run_dir:  # reference --run_dir redirection (:822-828)
        run = Path(args.run_dir)
        ckpt, sample, log = str(run / "checkpoints"), str(run / "samples"), str(run / "logs")
    return TrainConfig(
        model=ModelConfig(latent_dim=args.latent_dim, image_size=args.image_size,
                          use_spectral_norm=args.spectral_norm,
                          num_classes=args.num_classes,
                          g_conditioning=args.g_conditioning,
                          aux_classifier=args.aux_weight > 0),
        optim=OptimConfig(g_lr=args.g_lr, d_lr=args.d_lr, beta1=args.beta1,
                          beta2=args.beta2, gradient_clip_value=args.gradient_clip,
                          lr_schedule=args.lr_schedule),
        mesh=MeshConfig(num_data=args.num_data_devices),
        batch_size=args.batch_size, epochs=args.epochs,
        label_smoothing=args.label_smoothing, n_critic=args.n_critic,
        share_fakes=args.share_fakes,
        seed=args.seed, compute_dtype=args.compute_dtype,
        rng_impl=args.rng_impl,
        sample_interval=args.sample_interval,
        checkpoint_interval=args.checkpoint_interval,
        data_dir=args.data_dir, checkpoint_dir=ckpt, sample_dir=sample,
        log_dir=log, augment=not args.no_augment, hflip=args.hflip,
        profile_dir=args.profile_dir, fid_interval=args.fid_interval,
        ema_decay=args.ema_decay, aux_weight=args.aux_weight,
        diffaugment=args.diffaugment,
    )


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)
    cfg = build_config(args)

    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.train.trainer import GANTrainer

    ds = SignatureDataset(cfg.data_dir, cfg.model.image_size, max_images=args.max_images)
    print(f"Dataset: {ds.statistics()}", flush=True)
    labels = None
    if cfg.model.num_classes > 0:
        labels, names = ds.writer_labels()
        if len(names) != cfg.model.num_classes:
            raise SystemExit(f"--num_classes={cfg.model.num_classes} but "
                             f"found {len(names)} writer subdirs")
        print(f"Writers: {len(names)}", flush=True)
    trainer = GANTrainer(cfg, ds.images, stop_file=args.stop_file, device=device,
                         labels=labels)
    if args.resume or args.resume_from:
        which = args.resume_from or "latest"
        if which not in ("latest", "best"):
            which = int(which)
        if not trainer.resume(which):
            print("No checkpoint to resume from — starting fresh", flush=True)
    summary = trainer.train()
    print(f"Training summary: {summary}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
