#!/usr/bin/env python3
"""Phase 12's raster tree on the CPU: the counts the card's run must equal.

    python3 scripts/raster_tree_cpu.py --work DIR

Writes phase 11's 1320 scans (``chip_smoke.write_scans``) under DIR,
runs ``cli.preprocess --device cpu`` on their PNGs, then
``chip_smoke.raster_tree_step`` with every CLI on the CPU: the scans in the
formats of A.6.33-A.6.42 in turns under .png and .bmp names,
``cli.preprocess`` on them and a ``SignatureDataset`` (the greys written).
Prints the step's line and its numbers (``chip_smoke.RASTER_TREE_CPU_COUNTS``
holds its written and invalid counts); about 2 minutes on one core.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=Path, required=True)
    args = ap.parse_args(argv)
    from siggan_tpu_torch.cli import preprocess as pre_cli

    def run_cli(main_fn, argv):
        return chip_smoke.run_cli(main_fn, argv + ["--device", "cpu"])
    work = args.work
    work.mkdir(parents=True, exist_ok=True)
    chip_smoke.write_scans(work / "scans")
    run_cli(pre_cli.main, ["--input_dir", str(work / "scans"), "--output_dir", str(work / "clean")])
    print(chip_smoke.raster_tree_step("cpu", str(work), run_cli))


if __name__ == "__main__":
    main()
