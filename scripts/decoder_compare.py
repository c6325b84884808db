#!/usr/bin/env python3
"""Time the port's host decoder (``siggan_tpu_torch/data/native/decode.cpp``)
of this checkout against another checkout's, in one process, in turns, so
that their numbers compare.

    python3 scripts/decoder_compare.py --tree DIR [--rounds R] [--budget_s S]

``--tree`` is another checkout of the repo, such as a ``git archive`` of
the parent commit unpacked under ``build/``. Both decoders are built with
``g++`` and ``HOST_FLAGS`` (``ops/kernels/build.py::load_host``) and called
through ``sig_decode`` on one thread. The files are the committed decoder
fixtures that both trees hold and both decoders read (PNG is decoded
elsewhere) and a 1200 x 500 uncompressed one-strip grey TIFF written here
from scan_420.jpg's grey.
Each file is decoded by the other tree's decoder (A) and this one's (B) in
the order A, B, B, A, ``--rounds`` times, each turn ``reps`` decodes long
(about ``--budget_s`` seconds); the two must agree pixel for pixel. Prints
the card's name and power limit when ``nvidia-smi`` is there, one line per
file, and one JSON line: the median ms a decode of each, B's time over
A's, and the distance between A's quartiles (its own spread) per file,
and the geometric mean of the ratios over the baseline scan JPEGs
(``scan_*.jpg``) and over every file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib only at import: the fixtures, the TIFF writer)
from siggan_tpu_torch.data.native import loader as native  # noqa: E402
from siggan_tpu_torch.ops.kernels import build  # noqa: E402


def decoder(tree: Path) -> ctypes.CDLL:
    """The tree's decoder library, built from every C++ source of its
    ``data/native/`` (``decode.cpp`` first; ``webp.cpp`` where it has one)."""
    native_dir = tree / "siggan_tpu_torch" / "data" / "native"
    return build.load_host(sorted(native_dir.glob("*.cpp"), key=lambda p: p.name != "decode.cpp"),
                           native._SIGNATURES)


def decode(lib: ctypes.CDLL, data: bytes):
    """The grey image, or None where this decoder does not read the file."""
    ptr, w, h = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(native._MSG)
    st = lib.sig_decode(data, len(data), ctypes.byref(ptr), ctypes.byref(w), ctypes.byref(h),
                        msg, native._MSG)
    return native._take(lib, ptr.value, w.value, h.value) if st == native.OK else None


def turn_ms(lib: ctypes.CDLL, data: bytes, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        decode(lib, data)
    return 1e3 * (time.perf_counter() - t0) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--budget_s", type=float, default=0.05)
    args = ap.parse_args(argv)
    try:
        print(chip_smoke.nvidia_smi_line(), flush=True)
    except (OSError, subprocess.SubprocessError):
        print("no nvidia-smi: host only", flush=True)
    a, b = decoder(args.tree.resolve()), decoder(ROOT)
    golden = chip_smoke.golden_arrays()
    import numpy as np
    with np.load(args.tree / "tests" / "data" / "torch_port" / "golden.npz") as f:
        theirs = set(f.files) | {"progressive_page.jpg"}
    # The fixtures both trees hold: a decoder change's new fixtures may read
    # otherwise (or not at all) in the other tree.
    files = {n: (chip_smoke.FIXTURES / n).read_bytes() for n in sorted(golden) if n in theirs}
    files["raw_page.tif (1200x500, one strip)"] = chip_smoke.tiff_grey(golden["scan_420.jpg"])
    rows = {}
    for name, data in files.items():
        ia, ib = decode(a, data), decode(b, data)
        if ia is None or ib is None:
            continue
        if ia.shape != ib.shape or (ia != ib).any():
            raise AssertionError(f"{name}: the two decoders disagree")
        reps = max(3, int(args.budget_s / max(turn_ms(b, data, 3) * 1e-3, 1e-6)))
        ta, tb = [], []
        for _ in range(args.rounds):
            ta.append(turn_ms(a, data, reps))
            tb.append(turn_ms(b, data, reps))
            tb.append(turn_ms(b, data, reps))
            ta.append(turn_ms(a, data, reps))
        ma, mb = statistics.median(ta), statistics.median(tb)
        q1, _, q3 = statistics.quantiles(ta, n=4)
        rows[name] = {"a_ms": ma, "b_ms": mb, "b_over_a": mb / ma, "a_spread_ms": q3 - q1,
                      "reps": reps}
        print(f"{name}: A {ma:.4f} ms, B {mb:.4f} ms, B/A {mb / ma:.4f}, A's quartiles "
              f"{q3 - q1:.4f} ms apart ({args.rounds} rounds of A B B A, {reps} decodes a turn)",
              flush=True)

    def gmean(names):
        return math.exp(sum(math.log(rows[n]["b_over_a"]) for n in names) / len(names))
    scans = [n for n in rows if n.startswith("scan_")]
    print(json.dumps({"a": str(args.tree), "b": str(ROOT), "files": rows,
                      "b_over_a_scan_jpegs": gmean(scans), "b_over_a_all": gmean(list(rows))}))


if __name__ == "__main__":
    main()
