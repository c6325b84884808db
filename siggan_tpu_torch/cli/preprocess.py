"""Offline preprocessing CLI: the JAX package's flags on the port.

Usage:
    python -m siggan_tpu_torch.cli.preprocess --input_dir raw/ --output_dir clean/ \
        [--target_size 64] [--canvas_size 512] [--binarize] [--no_center] ... \
        [--device cuda]

Port of ``siggan_tpu/cli/preprocess.py``: cleans a directory of raw
signature scans (PNG, JPEG, BMP or TIFF, read by content; searched
recursively) into training-ready images. The host decodes each scan to
grayscale (``data/dataset.py::decode_gray``, PIL's grey bit for bit) and
letterboxes it at the top-left of a white
``canvas_size``-square canvas (a scan larger than the canvas is first
downscaled, aspect kept, with PIL's bilinear filter reproduced bit for bit
by the C++ host library, ``data/native/loader.py::resize_bilinear``); the device runs the batched pipeline
(``data/preprocess.py``) on ``batch_size`` canvases at a time, the last
chunk padded with copies of its last canvas to the full batch. Valid images
are written flat as ``<stem>.png`` (uint8), with ``preprocess_report.json``
listing the processed and the invalid files and the flags. It runs on the
card (``--device cpu`` runs the same code on the CPU, for tests) and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Preprocess raw signature scans")
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--target_size", type=int, default=64)
    p.add_argument("--canvas_size", type=int, default=512,
                   help="letterbox working resolution for variable-size scans")
    p.add_argument("--binarize", action="store_true")
    p.add_argument("--no_normalize", action="store_true",
                   help="write uint8 PNGs without the [-1, 1] round trip "
                        "(PNGs are always written denormalized)")
    p.add_argument("--no_crop", action="store_true")
    p.add_argument("--no_center", action="store_true")
    p.add_argument("--no_denoise", action="store_true")
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def load_canvas(path: Path, canvas: int) -> tuple[np.ndarray, tuple[int, int]]:
    """Decode to grayscale and letterbox onto a white (canvas, canvas)
    float32 array at the top-left; returns it and the image's (h, w).
    Images larger than the canvas are downscaled (aspect kept) first."""
    from siggan_tpu_torch.data.dataset import read_gray, resize

    gray, nearest = read_gray(path)
    h, w = gray.shape
    if max(w, h) > canvas:
        s = canvas / max(w, h)
        w, h = max(1, int(w * s)), max(1, int(h * s))
        gray = resize(gray, w, h, nearest)
    out = np.full((canvas, canvas), 255.0, np.float32)
    out[:h, :w] = gray
    return out, (h, w)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.core.platform import resolve_device
    device = resolve_device(args.device)

    import torch

    from siggan_tpu_torch.data.dataset import list_images
    from siggan_tpu_torch.data.preprocess import denormalize_pixels, preprocess_batch
    from siggan_tpu_torch.infer.export import encode_png

    paths = list_images(args.input_dir)
    if not paths:
        print(f"No images found under {args.input_dir}", file=sys.stderr)
        return 1
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    flags = dict(target_size=args.target_size, binarize=args.binarize,
                 normalize=not args.no_normalize,
                 remove_margin=not args.no_crop, center=not args.no_center,
                 denoise=not args.no_denoise, validate=not args.no_validate)

    n_ok = n_invalid = 0
    report = {"processed": [], "invalid": [], "flags": flags}
    B = args.batch_size
    for start in range(0, len(paths), B):
        chunk = paths[start:start + B]
        canvases, hws = zip(*(load_canvas(p, args.canvas_size) for p in chunk))
        # the tail chunk padded to the full batch, as the JAX CLI does
        pad = B - len(chunk)
        canv = np.stack(canvases + (canvases[-1],) * pad)
        hw = np.asarray(list(hws) + [hws[-1]] * pad, np.int32)
        imgs, valid = preprocess_batch(torch.from_numpy(canv).to(device),
                                       torch.from_numpy(hw).to(device), **flags)
        imgs = (denormalize_pixels(imgs) if not args.no_normalize
                else torch.clamp(imgs, 0, 255).to(torch.uint8))
        imgs, valid = imgs.cpu().numpy(), valid.cpu().numpy()
        for i, p in enumerate(chunk):
            if flags["validate"] and not valid[i]:
                n_invalid += 1
                report["invalid"].append(p.name)
                continue
            (out_dir / f"{p.stem}.png").write_bytes(encode_png(imgs[i]))
            report["processed"].append(p.name)
            n_ok += 1
        print(f"\r{start + len(chunk)}/{len(paths)} "
              f"(ok {n_ok}, invalid {n_invalid})", end="", flush=True)
    print()
    (out_dir / "preprocess_report.json").write_text(json.dumps(report, indent=2))
    print(f"Done: {n_ok} written, {n_invalid} rejected -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
