"""WebP writers for the port's WebP tests, without PIL. ``vp8l_stream``
encodes an ARGB image as VP8L with any transforms in any order (predictor
modes 0-15 by tile, cross-colour by tile, subtract green, a palette with
pixels bundled at 1, 2, 4 or 8 bits), a colour cache of 1-11 bits, a meta
Huffman image (group numbers past 1000 too), LZ77 with plane codes, and
either form of prefix code; Pillow's encoder picks these for itself.
``vp8_frame`` writes a VP8 key frame over a boolean encoder (RFC 6386's):
any header (segments, the simple filter, sharpness, loop-filter deltas,
quantiser deltas, 1-8 token partitions, coefficient probability updates,
skip or no skip probability) and any modes and coefficients, drawn from a
seed. ``alph_chunk`` and ``animation`` build the VP8X pieces."""

from __future__ import annotations

import numpy as np

import chip_smoke as cs

# ------------------------------------------------------------------- VP8L

def channels(p: int):
    return (p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255


def argb(a: int, r: int, g: int, b: int) -> int:
    return ((a & 255) << 24) | ((r & 255) << 16) | ((g & 255) << 8) | (b & 255)


def sub_pixels(x: int, y: int) -> int:
    return argb(*[(p - q) for p, q in zip(channels(x), channels(y))])


def average2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """The predictor ``mode`` of the VP8L format (14 and 15 as 0: black)."""
    if mode == 1:
        return left
    if mode in (2, 3, 4):
        return (top, tr, tl)[mode - 2]
    if mode == 5:
        return average2(average2(left, tr), top)
    if mode in (6, 7, 8, 9):
        return average2(*((left, tl), (left, top), (tl, top), (top, tr))[mode - 6])
    if mode == 10:
        return average2(average2(left, tl), average2(top, tr))
    if mode == 11:
        s = sum(abs(b - c) - abs(a - c) for a, b, c in zip(channels(top), channels(left), channels(tl)))
        return top if s <= 0 else left
    if mode == 12:
        return argb(*[clip255(a + b - c) for a, b, c in zip(channels(left), channels(top), channels(tl))])
    if mode == 13:
        ave = channels(average2(left, top))
        return argb(*[clip255(a + int((a - b) / 2)) for a, b in zip(ave, channels(tl))])
    return 0xFF000000


def delta(m: int, c: int) -> int:
    m, c = (m ^ 128) - 128, (c ^ 128) - 128
    return (m * c) >> 5


def prefix(v: int):
    """(symbol, extra value, extra bits) of a length or distance ``v`` >= 1."""
    x = v - 1
    if x < 4:
        return x, 0, 0
    hb = x.bit_length() - 1
    second = (x >> (hb - 1)) & 1
    return 2 * hb + second, x & ((1 << (hb - 1)) - 1), hb - 1


def subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def forward(img, t):
    """One transform forward: (its parameters' sub-image or None, the image
    it leaves)."""
    h, w = img.shape
    kind = t[0]
    out = img.copy()
    if kind == "green":
        for y in range(h):
            for x in range(w):
                a, r, g, b = channels(int(img[y, x]))
                out[y, x] = argb(a, r - g, g, b - g)
        return None, out
    if kind == "predictor":
        bits, modes = t[1], np.asarray(t[2])
        for y in range(h):
            for x in range(w):
                p = int(img[y, x])
                if y == 0:
                    pred = 0xFF000000 if x == 0 else int(img[0, x - 1])
                elif x == 0:
                    pred = int(img[y - 1, 0])
                else:
                    tr = int(img[y - 1, x + 1]) if x + 1 < w else int(img[y, 0])
                    pred = predict(int(modes[y >> bits, x >> bits]), int(img[y, x - 1]),
                                   int(img[y - 1, x]), int(img[y - 1, x - 1]), tr)
                out[y, x] = sub_pixels(p, pred)
        return np.vectorize(lambda m: argb(255, 0, int(m), 0), otypes=[np.int64])(modes), out
    if kind == "cross":
        bits, mults = t[1], np.asarray(t[2])
        for y in range(h):
            for x in range(w):
                g2r, g2b, r2b = (int(v) for v in mults[y >> bits, x >> bits])
                a, r, g, b = channels(int(img[y, x]))
                out[y, x] = argb(a, r - delta(g2r, g), g, b - delta(g2b, g) - delta(r2b, r))
        data = np.zeros(mults.shape[:2], np.int64)
        for (ty, tx), _ in np.ndenumerate(data):
            g2r, g2b, r2b = (int(v) for v in mults[ty, tx])
            data[ty, tx] = argb(255, r2b, g2b, g2r)
        return data, out
    # "palette": every pixel one of the palette's colours
    palette = [int(c) for c in t[1]]
    index = {c: i for i, c in enumerate(palette)}
    n = len(palette)
    bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
    per, width = 1 << bits, subsample(w, bits)
    packed = np.zeros((h, width), np.int64)
    for y in range(h):
        for x in range(w):
            packed[y, x >> bits] |= index[int(img[y, x])] << ((x & (per - 1)) * (8 >> bits))
    packed = 0xFF000000 | (packed << 8)
    deltas = [palette[0]] + [sub_pixels(palette[i], palette[i - 1]) for i in range(1, n)]
    return np.array([deltas], np.int64), packed


def tokens(img, cache_bits: int, lz77: bool):
    """The image's symbols in order: ("lit", argb), ("cache", key) or
    ("copy", length, distance), greedy, the cache kept as the reader keeps
    it."""
    h, w = img.shape
    flat = [int(v) for v in img.ravel()]
    cache = [None] * (1 << cache_bits) if cache_bits else None
    out, i = [], 0

    def key(p):
        return ((0x1E35A7BD * p) & 0xFFFFFFFF) >> (32 - cache_bits)

    while i < len(flat):
        best = (0, 0)
        if lz77:
            for dist in (1, w, w + 1, w - 1, 2, 2 * w, 3 * w + 5):
                if 1 <= dist <= i:
                    n = 0
                    while i + n < len(flat) and n < 4096 and flat[i + n] == flat[i + n - dist]:
                        n += 1
                    best = max(best, (n, dist))
        if best[0] >= 3:
            out.append(("copy", best[0], best[1]))
            step = best[0]
        elif cache is not None and cache[key(flat[i])] == flat[i]:
            out.append(("cache", key(flat[i])))
            step = 1
        else:
            out.append(("lit", flat[i]))
            step = 1
        if cache is not None:
            for p in flat[i:i + step]:
                cache[key(p)] = p
        i += step
    return out


def plane_code(dist: int, width: int) -> int:
    for c in range(1, 121):
        d = CODE_TO_PLANE[c - 1]
        if max(1, (d >> 4) * width + 8 - (d & 15)) == dist:
            return c
    return dist + 120


def write_image(bw, img, *, cache_bits=0, lz77=False, meta=None, simple=None, max_symbol=False,
                level0=False):
    """An image stream's colour cache, codes and data (``meta``: (bits,
    groups by tile) for the level-0 image; a group number a tile names need
    not be used, and each group up to the largest gets codes)."""
    h, w = img.shape
    bw.put(int(cache_bits > 0), 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    groups = np.zeros((1, 1), np.int64)
    mbits = 0
    if level0:
        bw.put(int(meta is not None), 1)
        if meta is not None:
            mbits, groups = meta[0], np.asarray(meta[1], np.int64)
            bw.put(mbits - 2, 3)
            write_image(bw, 0xFF000000 | ((groups >> 8) << 16) | ((groups & 255) << 8))
    toks = tokens(img, cache_bits, lz77)
    n_groups = int(groups.max()) + 1
    green = 280 + (1 << cache_bits if cache_bits else 0)
    hist = [[np.zeros(s, np.int64) for s in (green, 256, 256, 256, 40)] for _ in range(n_groups)]
    pos, placed = 0, []
    for t in toks:
        g = int(groups[(pos // w) >> mbits, (pos % w) >> mbits]) if mbits else 0
        hs = hist[g]
        if t[0] == "lit":
            a, r, gg, b = channels(t[1])
            hs[0][gg] += 1
            hs[1][r] += 1
            hs[2][b] += 1
            hs[3][a] += 1
            pos += 1
        elif t[0] == "cache":
            hs[0][280 + t[1]] += 1
            pos += 1
        else:
            lsym, _, _ = prefix(t[1])
            dsym, _, _ = prefix(plane_code(t[2], w))
            hs[0][256 + lsym] += 1
            hs[4][dsym] += 1
            pos += t[1]
        placed.append(g)
    codes = []
    for g in range(n_groups):
        cg = []
        for hh in hist[g]:
            if not hh.any():
                hh = hh.copy()
                hh[255 if hh is hist[g][3] else 0] = 1
            cg.append(cs.vp8l_prefix_code(bw, cs.huffman_lengths(hh), simple=simple, max_symbol=max_symbol))
        codes.append(cg)
    for t, g in zip(toks, placed):
        cg = codes[g]
        if t[0] == "lit":
            a, r, gg, b = channels(t[1])
            for j, v in ((0, gg), (1, r), (2, b), (3, a)):
                bw.code(int(cg[j][0][v]), int(cg[j][1][v]))
        elif t[0] == "cache":
            bw.code(int(cg[0][0][280 + t[1]]), int(cg[0][1][280 + t[1]]))
        else:
            lsym, lx, ln = prefix(t[1])
            dsym, dx, dn = prefix(plane_code(t[2], w))
            bw.code(int(cg[0][0][256 + lsym]), int(cg[0][1][256 + lsym]))
            bw.put(lx, ln)
            bw.code(int(cg[4][0][dsym]), int(cg[4][1][dsym]))
            bw.put(dx, dn)


def vp8l_stream(img, *, transforms=(), header=True, alpha_hint=False, **kw) -> bytes:
    """A VP8L bitstream of the (h, w) ARGB ``img`` (``header=False``: an
    ALPH chunk's stream, which has none); ``transforms`` in the order they
    are written: ("predictor", bits, modes by tile), ("cross", bits,
    (g2r, g2b, r2b) by tile), ("green",), ("palette", colours)."""
    img = np.asarray(img, np.int64)
    h, w = img.shape
    bw = cs.BitFields()
    if header:
        cs.vp8l_header(bw, w, h, alpha_hint)
    kinds = {"predictor": 0, "cross": 1, "green": 2, "palette": 3}
    for t in transforms:
        bw.put(1, 1)
        bw.put(kinds[t[0]], 2)
        data, img = forward(img, t)
        if t[0] in ("predictor", "cross"):
            bw.put(t[1] - 2, 3)
        elif t[0] == "palette":
            bw.put(len(t[1]) - 1, 8)
        if data is not None:
            write_image(bw, data)
    bw.put(0, 1)
    write_image(bw, img, level0=True, **kw)
    return bw.tobytes()


def vp8l_file(img, **kw) -> bytes:
    return cs.riff_webp([cs.webp_chunk(b"VP8L", vp8l_stream(img, **kw))])


# -------------------------------------------------------------------- VP8

class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, value: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if value:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1, 128)

    def signed(self, v: int, n: int):
        self.literal(abs(v), n)
        self.bit(int(v < 0), 128)

    def optional(self, v, n: int, signed=True):
        """A flag, then the value when it is not None."""
        self.bit(int(v is not None), 128)
        if v is not None:
            (self.signed if signed else self.literal)(v, n)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tables():
    """The VP8 constants the writer needs, read from the port's decoder
    source (they are RFC 6386's)."""
    import re
    from pathlib import Path
    src = (Path(cs.__file__).parent / "siggan_tpu_torch" / "data" / "native" / "webp.cpp").read_text()

    def arr(name):
        body = re.search(name + r"\[[^=]*= \{(.*?)\n\};", src, re.S).group(1)
        return np.array([int(v) for v in re.findall(r"\d+", body)])
    return (arr("kCoeffsProba0").reshape(4, 8, 3, 11), arr("kCoeffsUpdateProba").reshape(4, 8, 3, 11),
            arr("kBModesProba").reshape(10, 10, 9), tuple(arr("kCodeToPlane")))


COEFFS0, UPDATE, BMODES, CODE_TO_PLANE = _tables()
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the B-mode tree: mode -> its path of (node, bit)
B_PATH = {0: ((0, 0),), 1: ((0, 1), (1, 0)), 2: ((0, 1), (1, 1), (2, 0)),
          3: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 0)), 4: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)),
          5: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)), 6: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 0)),
          7: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)),
          8: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)),
          9: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1))}
Y16_PATH = {0: ((156, 0), (163, 0)), 2: ((156, 0), (163, 1)), 3: ((156, 1), (128, 0)), 1: ((156, 1), (128, 1))}
UV_PATH = {0: ((142, 0),), 2: ((142, 1), (114, 0)), 3: ((142, 1), (114, 1), (183, 0)),
           1: ((142, 1), (114, 1), (183, 1))}


def put_value(e: BoolEncoder, p, v: int):
    """A coefficient's magnitude ``v`` >= 2 (GetLargeValue's tree)."""
    if v <= 4:
        e.bit(0, p[3])
        e.bit(int(v > 2), p[4])
        if v > 2:
            e.bit(v - 3, p[5])
        return
    e.bit(1, p[3])
    if v <= 10:
        e.bit(0, p[6])
        e.bit(int(v > 6), p[7])
        if v <= 6:
            e.bit(v - 5, 159)
        else:
            e.bit((v - 7) >> 1, 165)
            e.bit((v - 7) & 1, 145)
        return
    e.bit(1, p[6])
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    e.bit(cat >> 1, p[8])
    e.bit(cat & 1, p[9 + (cat >> 1)])
    extra = v - (3 + (8 << cat))
    for k, prob in enumerate(CATS[cat]):
        e.bit((extra >> (len(CATS[cat]) - 1 - k)) & 1, prob)


def put_block(e: BoolEncoder, proba, typ: int, ctx: int, levels, first: int, run_to_end=False) -> int:
    """One block's tokens (GetCoeffs' order; ``levels`` in zigzag order);
    returns the reader's ``nz``. ``run_to_end``: zeros to the end instead
    of an end-of-block token, when the last level is zero."""
    last = max([n for n in range(first, 16) if levels[n]], default=-1)
    p = proba[typ][BANDS[first]][ctx]
    n = first
    while n < 16:
        if n > last and not (run_to_end and last < 15):
            e.bit(0, p[0])
            return n
        e.bit(1, p[0])
        while n < 16 and not levels[n]:
            e.bit(0, p[1])
            n += 1
            if n == 16:
                return 16
            p = proba[typ][BANDS[n]][0]
        e.bit(1, p[1])
        v = abs(int(levels[n]))
        nxt = proba[typ][BANDS[n + 1]]
        if v == 1:
            e.bit(0, p[2])
            p = nxt[1]
        else:
            e.bit(1, p[2])
            put_value(e, p, v)
            p = nxt[2]
        e.bit(int(levels[n] < 0), 128)
        n += 1
        if n > last and run_to_end:
            run_to_end = False
    return 16


def vp8_frame(rs, w: int, h: int, *, parts=1, simple=False, level=20, sharpness=0, lf_deltas=None,
              segments=None, skip_prob=200, q=40, q_deltas=(None,) * 5, updates=0.0, big=0.0,
              zero_rate=0.6, i4_rate=0.5, run_to_end=0.0, profile=0) -> bytes:
    """A VP8 key frame (the 'VP8 ' chunk's payload) of random modes and
    coefficient levels from ``rs``. ``segments``: (update_map, absolute,
    quantizers, filter strengths, tree probabilities), any part None;
    ``lf_deltas``: (reference deltas, mode deltas), 4 each, None to leave
    one out; ``skip_prob`` None writes no skip probability; ``updates``:
    the share of coefficient probabilities updated; ``big``: the share of
    levels drawn up to 2114 (category 6)."""
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    e = BoolEncoder()
    e.bit(0, 128)  # colour space
    e.bit(0, 128)  # clamping
    e.bit(int(segments is not None), 128)
    seg_probs = [255, 255, 255]
    update_map = False
    if segments is not None:
        update_map, absolute, quants, strengths, probs = segments
        e.bit(int(update_map), 128)
        e.bit(int(quants is not None or strengths is not None), 128)
        if quants is not None or strengths is not None:
            e.bit(int(absolute), 128)
            for v in quants or (None,) * 4:
                e.optional(v, 7)
            for v in strengths or (None,) * 4:
                e.optional(v, 6)
        if update_map:
            for k, v in enumerate(probs or (None,) * 3):
                e.optional(v, 8, signed=False)
                if v is not None:
                    seg_probs[k] = v
    e.bit(int(simple), 128)
    e.literal(level, 6)
    e.literal(sharpness, 3)
    e.bit(int(lf_deltas is not None), 128)
    if lf_deltas is not None:
        e.bit(1, 128)
        for v in list(lf_deltas[0]) + list(lf_deltas[1]):
            e.optional(v, 6)
    e.literal({1: 0, 2: 1, 4: 2, 8: 3}[parts], 2)
    e.literal(q, 7)
    for v in q_deltas:
        e.optional(v, 4)
    e.bit(0, 128)  # refresh entropy probs
    proba = COEFFS0.copy()
    for idx in np.ndindex(*proba.shape):
        upd = rs.rand() < updates
        e.bit(int(upd), int(UPDATE[idx]))
        if upd:
            proba[idx] = rs.randint(0, 256)
            e.literal(int(proba[idx]), 8)
    e.bit(int(skip_prob is not None), 128)
    if skip_prob is not None:
        e.literal(skip_prob, 8)
    tokens = [BoolEncoder() for _ in range(parts)]
    intra_t = np.zeros(4 * mb_w, np.int64)
    top_nz, top_dc = np.zeros(mb_w, np.int64), np.zeros(mb_w, np.int64)

    def level_draw():
        if rs.rand() < zero_rate:
            return 0
        v = int(rs.randint(1, 2115)) if rs.rand() < big else int(rs.choice([1, 1, 1, 2, 3, 5, 8, 12, 25, 50, 90]))
        return -v if rs.rand() < 0.5 else v

    for mb_y in range(mb_h):
        intra_l = np.zeros(4, np.int64)
        left_nz = left_dc = 0
        te = tokens[mb_y % parts]
        for mb_x in range(mb_w):
            if update_map:
                s = int(rs.randint(4))
                e.bit(int(s >= 2), seg_probs[0])
                e.bit(s & 1, seg_probs[1 + (s >> 1)])
            skip = skip_prob is not None and rs.rand() < 0.2
            if skip_prob is not None:
                e.bit(int(skip), skip_prob)
            i4 = rs.rand() < i4_rate
            e.bit(int(not i4), 145)
            if not i4:
                ymode = int(rs.randint(4))
                for prob, b in Y16_PATH[ymode]:
                    e.bit(b, prob)
                intra_t[4 * mb_x:4 * mb_x + 4] = ymode
                intra_l[:] = ymode
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rs.randint(10))
                        p = BMODES[intra_t[4 * mb_x + x], intra_l[y]]
                        for node, b in B_PATH[m]:
                            e.bit(b, int(p[node]))
                        intra_t[4 * mb_x + x] = m
                        intra_l[y] = m
            uv = int(rs.randint(4))
            for prob, b in UV_PATH[uv]:
                e.bit(b, prob)
            if skip:
                left_nz = top_nz[mb_x] = 0
                if not i4:
                    left_dc = top_dc[mb_x] = 0
                continue
            # ParseResiduals' order and contexts
            if not i4:
                lv = [level_draw() for _ in range(16)]
                nz = put_block(te, proba, 1, int(top_dc[mb_x] + left_dc), lv, 0, rs.rand() < run_to_end)
                top_dc[mb_x] = left_dc = int(nz > 0)
            first, typ = (0, 3) if i4 else (1, 0)
            tnz, lnz = int(top_nz[mb_x]) & 15, left_nz & 15
            for y in range(4):
                lbit = lnz & 1
                for x in range(4):
                    lv = [0] * first + [level_draw() for _ in range(16 - first)]
                    nz = put_block(te, proba, typ, lbit + (tnz & 1), lv, first, rs.rand() < run_to_end)
                    lbit = int(nz > first)
                    tnz = (tnz >> 1) | (lbit << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lbit << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = int(top_nz[mb_x]) >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    lbit = lnz & 1
                    for x in range(2):
                        lv = [level_draw() for _ in range(16)]
                        nz = put_block(te, proba, 2, lbit + (tnz & 1), lv, 0, rs.rand() < run_to_end)
                        lbit = int(nz > 0)
                        tnz = (tnz >> 1) | (lbit << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lbit << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mb_x], left_nz = out_t & 255, out_l & 255
    part0 = e.flush()
    streams = [t.flush() for t in tokens]
    tag = (profile << 1) | (1 << 4) | (len(part0) << 5)
    head = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + w.to_bytes(2, "little") + h.to_bytes(2, "little")
    sizes = b"".join(len(s).to_bytes(3, "little") for s in streams[:-1])
    return head + part0 + sizes + b"".join(streams)


def vp8_file(payload: bytes) -> bytes:
    return cs.riff_webp([cs.webp_chunk(b"VP8 ", payload)])


# --------------------------------------------------------------- VP8X parts

def alph_chunk(alpha, *, method=1, filt=0, pre=0, reserved=0, **vp8l) -> bytes:
    """An ALPH chunk of an (h, w) alpha plane: method 0 (the bytes as they
    are, the filter's residuals) or 1 (a VP8L stream of the plane in green,
    ``vp8l`` its options); the filter 0-3 and pre-processing bits stated."""
    a = np.asarray(alpha, np.int64)
    head = bytes([method | (filt << 2) | (pre << 4) | (reserved << 6)])
    if method == 0:
        return cs.webp_chunk(b"ALPH", head + a.astype(np.uint8).tobytes())
    return cs.webp_chunk(b"ALPH", head + vp8l_stream(0xFF000000 | (a << 8), header=False, **vp8l))


def anmf_chunk(x: int, y: int, w: int, h: int, frame_chunks: bytes, duration=100, flags=0) -> bytes:
    """An animation frame at (x, y) (stored halved: even offsets) of size
    w x h holding ``frame_chunks`` (ALPH, VP8 or VP8L)."""
    head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little") + duration.to_bytes(3, "little") + bytes([flags]))
    return cs.webp_chunk(b"ANMF", head + frame_chunks)


def animation(canvas, frames, *, background=0xFFFFFFFF, loops=0) -> bytes:
    """An animated WebP of (x, y, w, h, chunks) frames on a canvas (w, h)."""
    anim = cs.webp_chunk(b"ANIM", background.to_bytes(4, "little") + loops.to_bytes(2, "little"))
    return cs.riff_webp([cs.vp8x_chunk(canvas[0], canvas[1], 0x02), anim]
                        + [anmf_chunk(*f) for f in frames])
