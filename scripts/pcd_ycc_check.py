"""Holds the port's Photo CD colour conversion (``decode.cpp``'s
``PcdTables``, ``chip_smoke.pcd_ycc_tables``: PhotoYCC as Pillow's
ConvertYCC.c tables give it, int(k * (v - v0) + 0.5) each) against
Pillow's own ``YCC;P`` unpacker,
exhaustively: PCD base images (``chip_smoke.pcd_file``) whose 2 x 2 luma
blocks and their chroma samples take every (Y, Cr) pair for R, every
(Y, Cb) pair for B and every (Y, Cb, Cr) triple for G (43 files of
393,216 pixels), each compared with PIL's RGB channel by channel, and the
port's grey of each file with PIL's ``convert("L")``. Needs PIL (this is
no chip script).

    python scripts/pcd_ycc_check.py

prints the pairs and triples held and the files whose grey differs, and
exits 1 if any value differs."""

import io
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke as cs  # noqa: E402
from siggan_tpu_torch.data import dataset as tdataset  # noqa: E402

BLOCKS = 256 * 384  # chroma samples (2 x 2 luma blocks) of a base image


def planes(y4, cb, cr):
    """(512, 768) luma and (256, 384) chroma planes from per-block values:
    ``y4`` (BLOCKS, 4) the block's luma (top left, top right, bottom left,
    bottom right), ``cb`` and ``cr`` (BLOCKS,)."""
    y = y4.reshape(256, 384, 2, 2).transpose(0, 2, 1, 3).reshape(512, 768)
    return y.astype(np.uint8), cb.reshape(256, 384).astype(np.uint8), cr.reshape(256, 384).astype(np.uint8)


def model(y4, cb, cr):
    """The port's RGB of the blocks, clipped: (BLOCKS, 4, 3)."""
    lt, crt, grt, gbt, cbt = cs.pcd_ycc_tables()
    lum = lt[y4]
    rgb = np.stack([lum + crt[cr][:, None], lum + grt[cr][:, None] + gbt[cb][:, None], lum + cbt[cb][:, None]], -1)
    return np.clip(rgb, 0, 255)


def check(y4, cb, cr, path: Path, channels) -> tuple:
    """(values that differ in ``channels``, whether the port's grey differs)."""
    data = cs.pcd_file(*planes(y4, cb, cr))
    with Image.open(io.BytesIO(data)) as im:
        pil = np.asarray(im.convert("RGB")).astype(np.int64)
        grey = np.asarray(im.convert("L"))
    pil = pil.reshape(256, 2, 384, 2, 3).transpose(0, 2, 1, 3, 4).reshape(BLOCKS, 4, 3)
    bad = int((pil[..., channels] != model(y4, cb, cr)[..., channels]).sum())
    path.write_bytes(data)
    return bad, not np.array_equal(tdataset.decode_gray(path), grey)


def main() -> int:
    k = np.arange(BLOCKS)
    bad = grey_bad = files = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "f.pcd"
        # every (Y, C) pair: 64 blocks of 4 luma values for each chroma value
        y4 = (4 * (k // 256)[:, None] + np.arange(4)) % 256
        c, other = k % 256, (k * 7) % 256
        for name, args, ch in (("R (Y, Cr)", (other, c), [0]), ("B (Y, Cb)", (c, other), [2])):
            b, g = check(y4, *args, path, ch)
            bad, grey_bad, files = bad + b, grey_bad + g, files + 1
            print(f"{name}: 65536 pairs, {b} values differ from PIL's", flush=True)
        # every (Y, Cb, Cr) triple: block j of the whole run holds chroma pair j // 64, luma 4 (j % 64) ..
        total = 256 * 256 * 64
        g_bad = 0
        for start in range(0, total, BLOCKS):
            j = np.minimum(start + k, total - 1)
            pair = j // 64
            y4 = 4 * (j % 64)[:, None] + np.arange(4)
            b, g = check(y4, pair // 256, pair % 256, path, [0, 1, 2])
            g_bad, grey_bad, files = g_bad + b, grey_bad + g, files + 1
        bad += g_bad
        print(f"G (Y, Cb, Cr): {256 ** 3} triples over {files - 2} files, {g_bad} values of R, G or B "
              f"differ from PIL's", flush=True)
    print(f"port's grey differs from PIL's in {grey_bad} of {files} files")
    return 1 if bad or grey_bad else 0


if __name__ == "__main__":
    sys.exit(main())
