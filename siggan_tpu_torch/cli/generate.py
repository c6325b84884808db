"""Batch generation CLI: load a port checkpoint, generate N seeded images in
batches and save ``{prefix}_{i:06d}.png``; ``--which`` picks the epoch of a
run directory (``latest``, ``best`` or an epoch number); ``--info`` prints
the saved epochs and aliases, the architecture and the config;
``--grid``/``--zip`` exports and ``--interpolate`` as in the JAX package's
CLI.

Usage:
    python -m siggan_tpu_torch.cli.generate --checkpoint DIR --n_samples 100 \
        [--which best] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate signatures from a checkpoint")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint DIRECTORY (config.json + generator.npz, or a "
                        "training run's checkpoint directory with index.json)")
    p.add_argument("--which", type=str, default="latest",
                   help="'latest' | 'best' | epoch number")
    p.add_argument("--n_samples", type=int, default=100)
    p.add_argument("--output_dir", type=str, default="./generated")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--class_id", type=int, default=None,
                   help="conditional checkpoints: generate this writer class")
    p.add_argument("--noise_scale", type=float, default=1.0)
    p.add_argument("--prefix", type=str, default="signature")
    p.add_argument("--grid", action="store_true", help="also write a contact sheet")
    p.add_argument("--zip", dest="zip_path", type=str, default=None,
                   help="also write a ZIP of the PNGs to this path")
    p.add_argument("--interpolate", type=int, default=0, metavar="STEPS",
                   help="write a latent interpolation strip instead")
    p.add_argument("--info", action="store_true",
                   help="print checkpoint info and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def checkpoint_info(checkpoint_dir: str, which: str | int = "latest") -> dict:
    from siggan_tpu_torch.ckpt.manager import (CheckpointManager, infer_architecture,
                                               load_arrays, load_config)
    arrays = load_arrays(checkpoint_dir, which)
    cfg = load_config(checkpoint_dir)
    return {
        "available": CheckpointManager(checkpoint_dir, cfg).available(),
        "architecture": infer_architecture(arrays),
        "g_param_count": sum(int(a.size) for k, a in arrays.items()
                             if not k.startswith("bn/")),
        "config": cfg.to_dict(),
    }


def main(argv=None) -> int:
    args = parse_arguments(argv)
    which = args.which if args.which in ("latest", "best") else int(args.which)
    if args.info:
        print(json.dumps(checkpoint_info(args.checkpoint, which), indent=2))
        return 0

    from siggan_tpu_torch.infer.export import (contact_sheet, encode_png,
                                               save_pngs, zip_bytes)
    from siggan_tpu_torch.infer.generate import load_session
    from siggan_tpu_torch.utils.visualizer import make_grid, to_uint8

    session = load_session(args.checkpoint, which, device=args.device)

    if args.interpolate > 0:
        frames = session.interpolate(seed=args.seed, steps=args.interpolate)
        out = Path(args.output_dir) / "interpolation.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(encode_png(make_grid(to_uint8(frames), nrow=len(frames))))
        print(f"Wrote interpolation strip: {out}")
        return 0

    def progress(done, total):
        print(f"\rGenerated {done}/{total}", end="", flush=True)

    images = session.sample(args.n_samples, seed=args.seed,
                            noise_scale=args.noise_scale,
                            batch_size=args.batch_size, progress=progress,
                            class_id=args.class_id)
    print()
    paths = save_pngs(images, args.output_dir, prefix=args.prefix)
    print(f"Saved {len(paths)} images to {args.output_dir}")
    if args.grid:
        p = contact_sheet(images[:64], Path(args.output_dir) / "grid.png")
        print(f"Wrote grid: {p}")
    if args.zip_path:
        Path(args.zip_path).parent.mkdir(parents=True, exist_ok=True)
        Path(args.zip_path).write_bytes(zip_bytes(images, prefix=args.prefix))
        print(f"Wrote ZIP: {args.zip_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
