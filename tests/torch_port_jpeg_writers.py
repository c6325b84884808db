"""JPEG writers for the kinds PIL does not write, used by the decoder tests:
lossless JPEG (SOF3, ITU T.81 Annex H) and arithmetic-coded JPEG (SOF9
sequential, SOF10 progressive; the QM coder of Annex D with the statistics
of F.1.4 and G.1.3, as libjpeg's jcarith.c codes them). The arithmetic
writer codes the quantized coefficients of a baseline Huffman JPEG, which
``huffman_coefficients`` reads back, so that a test can hold PIL's reading
of the arithmetic file to its reading of the Huffman one. numpy only."""

from __future__ import annotations

import struct

import numpy as np

def seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def huffman_codes(bits, vals) -> dict:
    """symbol -> (code, length) of a DHT's 16 counts and its symbols."""
    code, k, out = 0, 0, {}
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class BitWriter:
    """Entropy-coded data, MSB first, an FF byte followed by 00; ``flush``
    pads the last byte with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, n: int) -> None:
        self.acc, self.n = (self.acc << n) | (v & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out += bytes([byte, 0] if byte == 0xFF else [byte])
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


# -- lossless (SOF3) ---------------------------------------------------------

# Every difference category 0 .. 16 has a code: 1 of 2 bits, 5 of 3, then
# one each of 4 .. 14 bits.
LOSSLESS_BITS = [0, 1, 5] + [1] * 11 + [0, 0]


def predict(psv: int, ra: int, rb: int, rc: int) -> int:
    """T.81 Table H.1, as libjpeg-turbo's jdlossls.c computes it."""
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_jpeg(planes, sampling=None, *, psv: int = 1, pt: int = 0, restart_rows: int = 0,
                  ids=None, jfif: bool = False, interleave: bool = True, size=None) -> bytes:
    """A lossless JPEG (SOF3, 8-bit) of ``planes``: uint8 arrays, one per
    component at its own (downsampled) size, with ``sampling`` (h, v) per
    component (1 x 1 each by default). Predictor ``psv`` (1 .. 7), point
    transform ``pt``; a restart every ``restart_rows`` MCU rows; one scan of
    every component, or (``interleave`` False) one scan each. ``size`` is
    the frame's (width, height), the first plane's by default."""
    planes = [np.asarray(p, np.int64) for p in planes]
    sampling = sampling or [(1, 1)] * len(planes)
    ids = ids or list(range(1, len(planes) + 1))
    w, h = size or planes[0].shape[::-1]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    codes = huffman_codes(LOSSLESS_BITS, list(range(17)))
    init = 1 << (8 - pt - 1)
    head = b"\xff\xd8"
    if jfif:
        head += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    head += seg(0xC4, bytes([0] + LOSSLESS_BITS) + bytes(range(17)))
    head += seg(0xC3, struct.pack(">BHHB", 8, h, w, len(planes)) + b"".join(
        bytes([ids[i], (sh << 4) | sv, 0]) for i, (sh, sv) in enumerate(sampling)))
    scans = [list(range(len(planes)))] if interleave else [[i] for i in range(len(planes))]
    body = b""
    for comps in scans:
        mcux = -(-w // hmax) if len(comps) > 1 else planes[comps[0]].shape[1]
        mcuy = -(-h // vmax) if len(comps) > 1 else planes[comps[0]].shape[0]
        if restart_rows:
            body += seg(0xDD, struct.pack(">H", restart_rows * mcux))
        bw = BitWriter()
        shifted = {ci: planes[ci] >> pt for ci in comps}
        first_row = {ci: 0 for ci in comps}  # each component's first row of the interval
        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
                for ci in comps:
                    first_row[ci] = my * (sampling[ci][1] if len(comps) > 1 else 1)
            for mx in range(mcux):
                for ci in comps:
                    sh, sv = sampling[ci] if len(comps) > 1 else (1, 1)
                    x = shifted[ci]
                    for v in range(sv):
                        for u in range(sh):
                            r, c = my * sv + v, mx * sh + u
                            if r >= x.shape[0] or c >= x.shape[1]:
                                d = 0  # a dummy sample past the component's edge
                            else:
                                if r == first_row[ci]:
                                    p = init if c == 0 else x[r, c - 1]
                                elif c == 0:
                                    p = x[r - 1, c]
                                else:
                                    p = predict(psv, x[r, c - 1], x[r - 1, c], x[r - 1, c - 1])
                                d = (int(x[r, c]) - int(p) + 0x8000) % 0x10000 - 0x8000
                            s = abs(d).bit_length()
                            bw.put(*codes[s])
                            if s:
                                bw.put(d if d >= 0 else d + (1 << s) - 1, s)
        bw.flush()
        sos = bytes([len(comps)]) + b"".join(bytes([ids[ci], 0]) for ci in comps)
        body += seg(0xDA, sos + bytes([psv, 0, pt])) + bytes(bw.out)
    return head + body + b"\xff\xd9"


# -- baseline Huffman coefficients ------------------------------------------------

def huffman_coefficients(data: bytes) -> dict:
    """A baseline (SOF0) Huffman JPEG of one interleaved scan, restart
    intervals allowed, read back to its quantized coefficients:
    ``segments`` (its DQT and APPn segments, as bytes), ``frame`` ((id, h,
    v, tq) per component), ``size`` (w, h) and ``blocks`` (per component,
    (block rows, block columns, 64) in zig-zag order over the MCU-padded
    plane)."""
    pos, segments, tables, comps, size, blocks, restart = 2, [], {}, [], None, None, 0
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDB or 0xE0 <= marker <= 0xEF:
            segments.append(bytes(data[pos - 2 - n:pos]))
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, counts = body[i], list(body[i + 1:i + 17])
                vals = list(body[i + 17:i + 17 + sum(counts)])
                codes = huffman_codes(counts, vals)
                tables[tc >> 4, tc & 15] = {c: s for s, c in codes.items()}
                i += 17 + sum(counts)
        elif marker == 0xDD:
            restart = struct.unpack(">H", body)[0]
        elif marker == 0xC0:
            h, w, nc = struct.unpack(">HHB", body[1:6])
            size = (w, h)
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
        elif marker == 0xDA:
            sel = {body[1 + 2 * i]: body[2 + 2 * i] for i in range(body[0])}
            break
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-size[0] // (8 * hmax)), -(-size[1] // (8 * vmax))
    blocks = [np.zeros((mcuy * v, mcux * h, 64), np.int64) for _, h, v, _ in comps]
    end = data.index(b"\xff\xd9", pos)
    intervals, start = [], pos
    for i in range(pos, end - 1):
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            intervals.append(data[start:i])
            start = i + 2
    intervals.append(data[start:end])
    bits, at = "", 0

    def symbol(table):
        nonlocal at
        for length in range(1, 17):
            code = (int(bits[at:at + length], 2), length)
            if code in table:
                at += length
                return table[code]
        raise ValueError("bad Huffman code")

    def value(s):
        nonlocal at
        if s == 0:
            return 0
        v = int(bits[at:at + s], 2)
        at += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1
    preds = [0] * len(comps)
    for n_mcu in range(mcux * mcuy):
        my, mx = divmod(n_mcu, mcux)
        if n_mcu == 0 or (restart and n_mcu % restart == 0):
            chunk = intervals.pop(0).replace(b"\xff\x00", b"\xff")
            bits, at, preds = "".join(format(b, "08b") for b in chunk), 0, [0] * len(comps)
        for ci, (cid, h, v, _) in enumerate(comps):
            dc, ac = tables[0, sel[cid] >> 4], tables[1, sel[cid] & 15]
            for y in range(v):
                for x in range(h):
                    b = blocks[ci][my * v + y, mx * h + x]
                    preds[ci] += value(symbol(dc))
                    b[0] = preds[ci]
                    k = 1
                    while k < 64:
                        rs = symbol(ac)
                        if rs == 0:
                            break
                        k += rs >> 4
                        if rs & 15:
                            b[k] = value(rs & 15)
                        k += 1
    return {"segments": segments, "frame": comps, "size": size, "blocks": blocks}


# -- non-interleaved Huffman scans ------------------------------------------------

# Flat Huffman tables that code every baseline symbol: the 12 DC categories
# in 4 bits, the 162 AC run/size symbols in 8 bits.
FLAT_DC = ([0, 0, 0, 12] + [0] * 12, list(range(12)))
FLAT_AC = ([0] * 7 + [162] + [0] * 8,
           [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)])


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


def _put_value(w: BitWriter, v: int, s: int) -> None:
    if s:
        w.put(v if v >= 0 else v + (1 << s) - 1, s)


def non_interleaved_jpeg(source: bytes, *, restart: int = 0, order=None) -> bytes:
    """The quantized coefficients of ``source`` (a baseline Huffman JPEG,
    ``huffman_coefficients``) as a baseline JPEG with one scan a component
    (T.81 A.2.2: each block an MCU, the component's own blocks in raster
    order), in the order ``order`` (component indices; all, in frame order,
    by default). ``restart``: blocks a restart interval, numbered from RST0
    in each scan. Every component codes with the flat tables 0."""
    src = huffman_coefficients(source)
    comps, (w, h) = src["frame"], src["size"]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    dc_codes, ac_codes = huffman_codes(*FLAT_DC), huffman_codes(*FLAT_AC)
    out = bytearray(b"\xff\xd8")
    for s in src["segments"]:
        out += s
    out += seg(0xC4, bytes([0x00] + FLAT_DC[0] + FLAT_DC[1]) +
               bytes([0x10] + FLAT_AC[0] + FLAT_AC[1]))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([cid, (ch << 4) | cv, tq]) for cid, ch, cv, tq in comps))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    for ci in (range(len(comps)) if order is None else order):
        cid, ch, cv, _ = comps[ci]
        bw_, bh_ = -(-(-(-w * ch // hmax)) // 8), -(-(-(-h * cv // vmax)) // 8)
        out += seg(0xDA, bytes([1, cid, 0x00, 0, 63, 0]))
        bits, pred, rst = BitWriter(), 0, 0
        for n in range(bw_ * bh_):
            if restart and n and n % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst])
                bits, pred, rst = BitWriter(), 0, (rst + 1) & 7
            b = src["blocks"][ci][n // bw_, n % bw_]
            s = _category(b[0] - pred)
            bits.put(*dc_codes[s])
            _put_value(bits, int(b[0] - pred), s)
            pred = b[0]
            run = 0
            last = max([k for k in range(1, 64) if b[k]], default=0)
            for k in range(1, last + 1):
                if b[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac_codes[0xF0])
                    run -= 16
                s = _category(b[k])
                bits.put(*ac_codes[(run << 4) | s])
                _put_value(bits, int(b[k]), s)
                run = 0
            if last < 63:
                bits.put(*ac_codes[0x00])
        bits.flush()
        out += bits.out
    return bytes(out) + b"\xff\xd9"


# -- the QM coder and arithmetic-coded JPEG --------------------------------------

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) per state.
QM_STATES = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]  # the last: libjpeg's fixed 0.5 state


class QMEncoder:
    """The QM coder's encoder (T.81 D.1), as jcarith.c's arith_encode and
    finish_pass; a state is a bin's value: index | MPS << 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct, self.sc, self.zc, self.buffer = 0, 0x10000, 11, 0, 0, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        self.out += b"\0" * self.zc
        self.zc = 0

    def encode(self, bins, i: int, val: int) -> None:
        sv = bins[i]
        qe, nl, nm, switch = QM_STATES[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nm
        while True:  # renormalization and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


# Full progressive scripts of (component indices, Ss, Se, Ah, Al): every
# coefficient refined to Al 0, so libjpeg does not smooth and the pixels
# are the sequential file's.
SCRIPT3 = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
           ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
           ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
SCRIPT1 = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
           ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]


def arith_jpeg(source: bytes, *, scans=None, restart: int = 0, dac=()) -> bytes:
    """The quantized coefficients of ``source`` (a baseline Huffman JPEG,
    ``huffman_coefficients``) in an arithmetic-coded JPEG: sequential
    (SOF9, one interleaved scan) when ``scans`` is None, else progressive
    (SOF10) with ``scans`` a list of (component indices, Ss, Se, Ah, Al).
    ``restart``: MCUs a restart interval; ``dac``: (index, value) pairs of
    a DAC segment (index < 16: DC table, value U << 4 | L; else AC table
    index - 16, value K). Every component codes with table 0."""
    src = huffman_coefficients(source)
    comps, (w, h) = src["frame"], src["size"]
    blocks = src["blocks"]
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for index, val in dac:
        if index < 16:
            dc_l[index], dc_u[index] = val & 15, val >> 4
        else:
            ac_k[index - 16] = val
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    out = bytearray(b"\xff\xd8")
    for s in src["segments"]:
        out += s
    if dac:
        out += seg(0xCC, b"".join(bytes([i, v]) for i, v in dac))
    marker = 0xC9 if scans is None else 0xCA
    out += seg(marker, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([cid, (ch << 4) | cv, tq]) for cid, ch, cv, tq in comps))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    for comp_ids, ss, se, ah, al in scans or [(list(range(len(comps))), 0, 63, 0, 0)]:
        out += seg(0xDA, bytes([len(comp_ids)]) + b"".join(
            bytes([comps[ci][0], 0]) for ci in comp_ids) + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(blocks, comps, comp_ids, (hmax, vmax, w, h), scans is not None,
                           ss, se, ah, al, restart, dc_l, dc_u, ac_k)
    return bytes(out) + b"\xff\xd9"


def _arith_scan(blocks, comps, comp_ids, geometry, progressive, ss, se, ah, al, restart,
                dc_l, dc_u, ac_k) -> bytes:
    """One scan's data, as jcarith.c's encode_mcu (sequential) or its
    progressive routines (DC first, DC refine, AC first, AC refine)."""
    hmax, vmax, w, h = geometry
    enc, out = QMEncoder(), bytearray()
    fixed = [113]

    def fresh():
        return [0] * 64, [0] * 256, [0] * len(comps), [0] * len(comps)
    dc_bins, ac_bins, last, ctx = fresh()
    if len(comp_ids) > 1:
        mcus = [(my, mx) for my in range(-(-h // (8 * vmax))) for mx in range(-(-w // (8 * hmax)))]
    else:
        ch, cv = comps[comp_ids[0]][1:3]
        rows, cols = -(-(-(-h * cv // vmax)) // 8), -(-(-(-w * ch // hmax)) // 8)
        mcus = [(r, c) for r in range(rows) for c in range(cols)]

    def dc_first(ci, coef):
        m = coef >> al  # arithmetic shift
        st = ctx[ci]
        v = m - last[ci]
        if v == 0:
            enc.encode(dc_bins, st, 0)
            ctx[ci] = 0
            return
        last[ci] = m
        enc.encode(dc_bins, st, 1)
        if v > 0:
            enc.encode(dc_bins, st + 1, 0)
            st += 2
            ctx[ci] = 4
        else:
            v = -v
            enc.encode(dc_bins, st + 1, 1)
            st += 3
            ctx[ci] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(dc_bins, st, 1)
            m, v2, st = 1, v, 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(dc_bins, st, 1)
                m <<= 1
                st += 1
        enc.encode(dc_bins, st, 0)
        if m < (1 << dc_l[0]) >> 1:
            ctx[ci] = 0
        elif m > (1 << dc_u[0]) >> 1:
            ctx[ci] += 8
        st += 14
        while m >> 1:
            m >>= 1
            enc.encode(dc_bins, st, 1 if m & v else 0)

    def shifted(x, shift):  # magnitude >> shift, sign kept
        return (x >> shift) if x >= 0 else -((-x) >> shift)

    def ac_first(b, lo, hi, shift):
        ke = hi
        while ke > 0 and shifted(int(b[ke]), shift) == 0:
            ke -= 1
        k = lo
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(ac_bins, st, 0)
            while True:
                v = shifted(int(b[k]), shift)
                if v:
                    enc.encode(ac_bins, st + 1, 1)
                    enc.encode(fixed, 0, 1 if v < 0 else 0)
                    break
                enc.encode(ac_bins, st + 1, 0)
                st += 3
                k += 1
            v = abs(v)
            st += 2
            m = 0
            v -= 1
            if v:
                enc.encode(ac_bins, st, 1)
                m, v2 = 1, v
                if v2 >> 1:
                    v2 >>= 1
                    enc.encode(ac_bins, st, 1)
                    m <<= 1
                    st = 189 if k <= ac_k[0] else 217
                    while v2 >> 1:
                        v2 >>= 1
                        enc.encode(ac_bins, st, 1)
                        m <<= 1
                        st += 1
            enc.encode(ac_bins, st, 0)
            st += 14
            while m >> 1:
                m >>= 1
                enc.encode(ac_bins, st, 1 if m & v else 0)
            k += 1
        if k <= hi:
            enc.encode(ac_bins, 3 * (k - 1), 1)

    def ac_refine(b):
        ke = se
        while ke > 0 and shifted(int(b[ke]), al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(int(b[kex]), ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(ac_bins, st, 0)
            while True:
                v = shifted(int(b[k]), al)
                if v:
                    if abs(v) >> 1:
                        enc.encode(ac_bins, st + 2, abs(v) & 1)
                    else:
                        enc.encode(ac_bins, st + 1, 1)
                        enc.encode(fixed, 0, 1 if v < 0 else 0)
                    break
                enc.encode(ac_bins, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(ac_bins, 3 * (k - 1), 1)

    for n_mcu, (my, mx) in enumerate(mcus):
        if restart and n_mcu and n_mcu % restart == 0:
            out += enc.finish() + bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
            enc = QMEncoder()
            dc_bins, ac_bins, last, ctx = fresh()
        for ci in comp_ids:
            ch, cv = comps[ci][1:3]
            cells = ([(my * cv + y, mx * ch + x) for y in range(cv) for x in range(ch)]
                     if len(comp_ids) > 1 else [(my, mx)])
            for r, c in cells:
                b = blocks[ci][r, c]
                if not progressive:
                    dc_first(ci, int(b[0]))
                    ac_first(b, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    dc_first(ci, int(b[0]))
                elif ss == 0:
                    enc.encode(fixed, 0, (int(b[0]) >> al) & 1)
                elif ah == 0:
                    ac_first(b, ss, se, al)
                else:
                    ac_refine(b)
    return bytes(out + enc.finish())


def lossless_arith_jpeg(img, *, psv: int = 1) -> bytes:
    """A lossless arithmetic-coded JPEG (SOF11) of uint8 grey ``img``: the
    differences from predictor ``psv`` (T.81 Table H.1, the first row and
    column as in ``lossless_jpeg``) coded by the QM coder as T.81 H.1.2.3
    conditions them: as a DC difference (F.1.4.1), its zero, sign and first
    magnitude decisions in one of 25 contexts by the classes of the
    differences to the left (Da) and above (Db) (conditioning bounds L = 0,
    U = 1), its magnitude bins in one of two sets by Db's class (small or
    large). libjpeg has no decoder for it."""
    x = np.asarray(img, np.int64)
    h, w = x.shape
    enc, bins = QMEncoder(), [0] * (100 + 2 * 29)
    diff = np.zeros((h, w), np.int64)

    def cls(d):  # 0 zero, 1 / 2 small + / -, 3 / 4 large + / -
        return 0 if d == 0 else (1 if d > 0 else 2) if abs(d) <= 2 else (3 if d > 0 else 4)
    for r in range(h):
        for c in range(w):
            if r == 0:
                p = 128 if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, c]
            else:
                p = predict(psv, x[r, c - 1], x[r - 1, c], x[r - 1, c - 1])
            v = int((x[r, c] - p + 0x8000) % 0x10000 - 0x8000)
            diff[r, c] = v
            da, db = cls(diff[r, c - 1]) if c else 0, cls(diff[r - 1, c]) if r else 0
            st = 4 * (5 * da + db)
            if v == 0:
                enc.encode(bins, st, 0)
                continue
            enc.encode(bins, st, 1)
            enc.encode(bins, st + 1, int(v < 0))
            st += 2 + int(v < 0)
            m, v = 0, abs(v) - 1
            if v:
                enc.encode(bins, st, 1)
                m, v2, st = 1, v, 100 + 29 * (db > 2)
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(bins, st, 1)
                    m <<= 1
                    st += 1
            enc.encode(bins, st, 0)
            st += 14
            while m >> 1:
                m >>= 1
                enc.encode(bins, st, int(bool(m & v)))
    return (b"\xff\xd8" + seg(0xCB, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0]))
            + seg(0xDA, bytes([1, 1, 0, psv, 0, 0])) + enc.finish() + b"\xff\xd9")
