#!/usr/bin/env python3
"""Decode rates of phase 12's A.6 pages on this host, as ``chip_smoke.py``'s
phase 12 times them: ``native.decode_files`` over ``--reps`` copies of a
page at 1 and 8 threads, after one warm call each.

    python3 scripts/page_rates.py [--pages header,texture] [--reps 100] [--runs 2]

``--pages`` names ``chip_smoke``'s page functions (``a6_<name>_pages``);
the pages are written to a temporary directory. Prints one line a page and
thread count: images/s of each run."""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", default="header,texture")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    from siggan_tpu_torch.data.native import loader as native
    golden = chip_smoke.golden_arrays()
    pages = {}
    for name in args.pages.split(","):
        pages.update(getattr(chip_smoke, f"a6_{name}_pages")(golden))
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in pages.items():
            path = Path(tmp) / name
            path.write_bytes(data)
            for threads in (1, 8):
                native.decode_files([path], threads)
                rates = []
                for _ in range(args.runs):
                    t0 = time.perf_counter()
                    _, status, _, _ = native.decode_files([path] * args.reps, threads)
                    rates.append(args.reps / (time.perf_counter() - t0))
                    if (status != native.OK).any():
                        raise SystemExit(f"{name}: statuses {set(status.tolist())}")
                print(f"{name}, {threads} thread{'s' if threads > 1 else ''}: "
                      + " / ".join(f"{r:.1f}" for r in rates) + " images/s", flush=True)


if __name__ == "__main__":
    main()
