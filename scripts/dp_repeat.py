#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16b (two gloo ranks on one card against one
process, ``chip_smoke.dp_two_ranks``) several times in one process, and
check that every run gives the same numbers.

    python3 scripts/dp_repeat.py [--runs N]

Builds the kernels as ``chip_smoke.py`` does, then runs phase 16b ``--runs``
times (5 by default), each in a fresh temporary directory with freshly
spawned ranks. Prints the card's name and power limit, per run and f32
configuration the max abs diff and one process's spread by part, and one
JSON line: whether every run passed, whether the f32 numbers of every run
are bit-identical to the first run's, and the numbers. Exits non-zero
unless every run passed with the same f32 numbers. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def f32_numbers(b_out: dict) -> dict:
    """Per f32 configuration, its diffs and spreads by part, as floats' hex
    strings (bit-exact under comparison and JSON)."""
    return {name: {key: {part: float(v).hex() for part, v in c[key].items()}
                   for key in ("max_abs_diff_by_part", "one_process_spread_by_part")}
            for name, c in b_out["configs"].items() if name.endswith("f32")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dp_repeat: no CUDA card", file=sys.stderr)
        return 1
    from siggan_tpu_torch.ops.kernels import build
    card = chip_smoke.nvidia_smi_line()
    print(card, flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            try:
                numbers, error = f32_numbers(chip_smoke.dp_two_ranks(work)), None
            except AssertionError as e:
                numbers, error = None, str(e)
        runs.append({"numbers": numbers, "error": error, "s": time.perf_counter() - t0})
        print(f"run {i + 1}: {'passed' if error is None else 'FAILED: ' + error} in "
              f"{runs[-1]['s']:.1f} s; f32 numbers {json.dumps(numbers)} [{card}]", flush=True)
    passed = all(r["error"] is None for r in runs)
    same = passed and all(r["numbers"] == runs[0]["numbers"] for r in runs)
    print(json.dumps({"card": card, "runs": len(runs), "all_passed": passed,
                      "f32_bit_identical": same, "per_run": runs}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
