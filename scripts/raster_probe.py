"""The damage probe of A.6.33-A.6.63 and C.23-C.25: damaged files of each
format (DIB, BMP, ICO, CUR, TGA, PCX, DCX, SGI, SUN, MSP, QOI, PNG, IM, XBM,
XPM, XV thumbnail, PSD, DDS by route, FTEX, BLP, SPIDER, PIXAR, GBR, McIdas,
IMT, FITS and IPTC by route, FLI and PCD), from Pillow's writers and
hand-built ones (``tests/torch_port_raster_cases.py``,
``tests/torch_port_text_cases.py``, ``tests/torch_port_texture_cases.py``,
``tests/torch_port_header_cases.py``),
and, as the format OJPEG-PLANES, planar YCbCr old-style JPEG-in-TIFF in
strips and tiles damaged by ``tests/test_torch_port_ojpeg_planes.py::damaged``,
each held to PIL's verdict: the port's grey bit-equal where PIL reads the
file, corrupt where PIL refuses it. Needs PIL (this is no chip script).

    python scripts/raster_probe.py [--n 3000] [--seed 0] [--formats TGA,PCX,XPM]

prints per format the files PIL read and refused and the first files that
differ, and exits 1 if any does. A damaged DDS of the RGB route whose size
PIL's Python decoder would loop over for minutes (``pil_slow``) is counted
apart and not held. ``--asan`` runs the same under
AddressSanitizer: the library built with ``-fsanitize=address`` into a
temporary directory, the script run again with libasan and libstdc++
preloaded (libasan alone fails intercepting ``__cxa_throw``); a fault
aborts it."""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
from torch_port_header_cases import BASES as HEADER_BASES  # noqa: E402
from torch_port_raster_cases import BASES as RASTER_BASES  # noqa: E402
from torch_port_raster_cases import damage, holds  # noqa: E402
from torch_port_text_cases import BASES as TEXT_BASES  # noqa: E402
from torch_port_texture_cases import BASES as TEXTURE_BASES  # noqa: E402
from torch_port_texture_cases import PIL_SLOW_PIXELS, pil_slow  # noqa: E402
from test_torch_port_ojpeg_planes import damaged  # noqa: E402

BASES = {**RASTER_BASES, **TEXT_BASES, **TEXTURE_BASES, **HEADER_BASES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=3000, help="damaged files a format")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--formats", default=",".join([*BASES, "OJPEG-PLANES"]))
    p.add_argument("--asan", action="store_true", help="under AddressSanitizer")
    args = p.parse_args(argv)
    if args.asan and "libasan" not in os.environ.get("LD_PRELOAD", ""):
        libs = [subprocess.run(["gcc", f"-print-file-name={n}"], capture_output=True, text=True,
                               check=True).stdout.strip() for n in ("libasan.so", "libstdc++.so.6")]
        env = {**os.environ, "LD_PRELOAD": " ".join(libs), "ASAN_OPTIONS": "detect_leaks=0"}
        return subprocess.run([sys.executable, *sys.argv], env=env).returncode
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        if args.asan:
            from siggan_tpu_torch.ops.kernels import build
            build.HOST_FLAGS = [*build.HOST_FLAGS, "-fsanitize=address", "-fno-omit-frame-pointer"]
            build.BUILD_DIR = Path(tmp) / "build"
        path = Path(tmp) / "f.png"
        for fmt in args.formats.split(","):
            bases = BASES[fmt]() if fmt in BASES else []
            rs = np.random.RandomState(args.seed)
            counts, wrong, slow = {}, [], 0
            for i in range(args.n):
                data = damage(rs, bases[i % len(bases)]) if bases else damaged(args.seed * args.n + i)[2]
                if pil_slow(data):
                    slow += 1
                    continue
                try:
                    got, want = holds(path, data)
                except AssertionError as e:
                    wrong.append(f"{i}: {str(e).splitlines()[0]}")
                    continue
                counts.setdefault(str(got), [0, 0])[want is None] += 1
            bad += len(wrong)
            print(f"{fmt}: {len(bases) or 'seeded'} bases, {args.n} damaged; PIL's format: [read, refused] "
                  f"{counts}; {len(wrong)} read otherwise than PIL"
                  + (f"; {slow} not held (a DDS of more than {PIL_SLOW_PIXELS} pixels for PIL's "
                     "Python RGB decoder)" if slow else ""), flush=True)
            for w in wrong[:5]:
                print(f"  {w}")
    print(f"files read otherwise than PIL: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
