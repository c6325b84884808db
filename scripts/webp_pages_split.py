#!/usr/bin/env python3
"""Where phase 12's WebP pages spend their decode time on this host.

    python3 scripts/webp_pages_split.py [--rounds R] [--reps N]

The port's decoder, one thread, ``loader.decode`` call by call on the
three pages of ``tests/data/torch_port_webp/``, and on the alpha page with
its VP8X alpha flag cleared (libwebp's demuxer then drops the ALPH chunk:
the VP8 frame alone), so the alpha plane's share is the difference.
Prints the card's name and power limit when ``nvidia-smi`` is there, and
ms a decode per file per round.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib only at import)
from siggan_tpu_torch.data.native import loader as native  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args(argv)
    try:
        print(chip_smoke.nvidia_smi_line(), flush=True)
    except (OSError, subprocess.SubprocessError):
        print("no nvidia-smi: host only", flush=True)
    alpha = (chip_smoke.WEBP_PAGES / "webp_alpha_page.webp").read_bytes()
    no_alpha = bytearray(alpha)
    no_alpha[20] &= ~0x10  # the VP8X flags byte
    files = {"alpha page": alpha, "alpha page, ALPH dropped": bytes(no_alpha),
             "lossy page": (chip_smoke.WEBP_PAGES / "webp_lossy_page.webp").read_bytes(),
             "lossless page": (chip_smoke.WEBP_PAGES / "webp_lossless_page.webp").read_bytes()}
    for rnd in range(args.rounds):
        for name, data in files.items():
            native.decode(data)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                native.decode(data)
            print(f"round {rnd}: {name}: {1e3 * (time.perf_counter() - t0) / args.reps:.3f} ms a decode",
                  flush=True)


if __name__ == "__main__":
    main()
