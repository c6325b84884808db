"""Training CLI: the JAX package's flags on the port's trainer.

Usage:
    python -m siggan_tpu_torch.cli.train --data_dir DIR --epochs 200 \
        [--batch_size 64] [--run_dir runs/exp1] [--resume] [--device cuda]

Trains on one CUDA card, or data-parallel on several (below); ``--device
cpu`` runs the same code on the CPU, for tests. Without a card it raises
rather than fall back. On the card the
steps run in windows of K (the JAX trainer's ``scan_steps`` rule), each a
CUDA graph of one step replayed K times. ``--data_dir`` holds the JAX
package's image files (PNG, JPEG, BMP, TIFF). ``--spectral_norm`` with ``--image_size
128`` trains v1.1. ``--num_classes N`` trains a conditional model on the
per-writer subdirectories of ``--data_dir`` (exactly N of them); v2.0 is

    --num_classes 8 --g_conditioning concat --spectral_norm --latent_dim 200
    --d_lr 1e-4 --g_lr 2e-4 --lr_schedule linear --diffaugment translation,cutout

and ``--ema_decay``, ``--aux_weight``, ``--lr_schedule`` and
``--diffaugment`` train as in the JAX package. ``--fid_interval N``
scores a random-init FID every N epochs (logged as ``fid``) and makes the
``best`` checkpoint follow the lowest FID. ``--share_fakes`` trains with
one latent batch a step, shared by the D and G updates. ``--profile_dir
DIR`` writes a ``torch.profiler`` Chrome trace of the epoch after the first
there. A dataset over ``resident_max_mb`` streams from host memory (one
graphed step a batch).

Several cards, one process each, train what one card trains at the same
global ``--batch_size`` (global-batch BatchNorm, gradients and metrics
averaged over the ranks; each rank takes its rows of every batch):

    python -m siggan_tpu_torch.cli.train --data_dir DIR --num_data_devices 4
    torchrun --nproc_per_node 4 -m siggan_tpu_torch.cli.train --data_dir DIR

The first starts the ranks itself (on localhost); the second joins the
ranks torchrun started (or a job named by ``SIGGAN_COORDINATOR``,
``SIGGAN_NUM_PROCS`` and ``SIGGAN_PROC_ID``). ``--num_data_devices -1``,
the default, means every visible card: on a machine with one card that is
the one-card run, with no process group. The cards talk over NCCL; with
``--device cpu`` the ranks are processes on the CPU that talk over gloo.
Rank 0 alone writes logs, samples and checkpoints, and the stop file ends
every rank.
The checkpoint directory serves with ``python -m siggan_tpu_torch.cli.serve
--checkpoint DIR`` (its latest epoch), and ``cli.generate --which`` samples
any saved epoch. ``--resume`` takes the architecture fields no flag sets
(``base_features``, ``g_activation``, ...) from the checkpoint directory's
``config.json``, so a run saved at another width (one imported from the JAX
package by ``scripts/import_jax_run.py``, say) resumes as it was built.
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
                   help="ranks on the data axis, one process per card "
                        "(-1 = all visible devices; the CPU counts as one)")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of one epoch here")
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


# ModelConfig fields that a flag of this CLI sets.
FLAG_MODEL_FIELDS = ("latent_dim", "image_size", "use_spectral_norm", "num_classes",
                     "g_conditioning", "aux_classifier")


def resume_config(cfg):
    """``cfg`` with the model fields no flag sets taken from the checkpoint
    directory's sidecar, when there is one."""
    import dataclasses
    from siggan_tpu_torch.core.config import TrainConfig
    sidecar = Path(cfg.checkpoint_dir) / "config.json"
    if not sidecar.exists():
        return cfg
    saved = TrainConfig.from_json(sidecar.read_text()).model
    model = dataclasses.replace(saved, **{k: getattr(cfg.model, k) for k in FLAG_MODEL_FIELDS})
    return cfg.replace(model=model)


def ranks_to_start(args: argparse.Namespace) -> int:
    """How many local ranks ``main`` starts itself: 0 inside a job that is
    already launched (torchrun's or the JAX package's variables), else the
    ranks ``--num_data_devices`` asks for (-1: every visible card; the CPU
    counts as one). Raises for more cards than are visible and for a
    global batch the ranks do not divide."""
    import os
    if os.environ.get("WORLD_SIZE") or os.environ.get("SIGGAN_NUM_PROCS"):
        return 0
    import torch
    cuda = args.device.startswith("cuda")
    visible = torch.cuda.device_count() if cuda else 1
    n = args.num_data_devices if args.num_data_devices > 0 else max(visible, 1)
    if cuda and 1 < n and visible < n:
        raise ValueError(f"mesh ({n} data x 1 model = {n} devices) exceeds the {visible} "
                         "visible devices")
    if args.batch_size % n:
        raise ValueError(f"global batch {args.batch_size} not divisible by data-axis size {n}")
    return n


def main(argv=None) -> int:
    args = parse_arguments(argv)
    n = ranks_to_start(args)
    if n > 1:
        from siggan_tpu_torch.parallel.mesh import spawn
        spawn(main, n, list(sys.argv[1:] if argv is None else argv))
        return 0
    from siggan_tpu_torch.core.platform import init_distributed, resolve_device
    joined = init_distributed(args.device)
    try:
        return _train(args)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> int:
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.resume or args.resume_from:
        cfg = resume_config(cfg)

    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.train.trainer import GANTrainer

    ds = SignatureDataset(cfg.data_dir, cfg.model.image_size, max_images=args.max_images)
    import torch.distributed as dist
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if main_rank:
        print(f"Dataset: {ds.statistics()}", flush=True)
    labels = None
    if cfg.model.num_classes > 0:
        labels, names = ds.writer_labels()
        if len(names) != cfg.model.num_classes:
            raise SystemExit(f"--num_classes={cfg.model.num_classes} but "
                             f"found {len(names)} writer subdirs")
        if main_rank:
            print(f"Writers: {len(names)}", flush=True)
    trainer = GANTrainer(cfg, ds.images, stop_file=args.stop_file, device=device,
                         labels=labels)
    if args.resume or args.resume_from:
        which = args.resume_from or "latest"
        if which not in ("latest", "best"):
            which = int(which)
        if not trainer.resume(which) and main_rank:
            print("No checkpoint to resume from — starting fresh", flush=True)
    summary = trainer.train()
    if main_rank:
        print(f"Training summary: {summary}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
