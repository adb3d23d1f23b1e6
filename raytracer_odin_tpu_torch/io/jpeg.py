"""From-scratch baseline JPEG (ITU T.81) decoder.

Covers what the reference gets from its vendored stb_image JPEG path
(textures.odin:36-52): baseline sequential DCT (SOF0), 8-bit samples,
Huffman entropy coding (DHT), 8/16-bit quantization tables (DQT), restart
intervals (DRI/RSTn), grayscale and YCbCr with arbitrary 1-2x chroma
subsampling, JFIF/EXIF APPn segments skipped. Extended-sequential (SOF1)
decodes identically. Progressive (SOF2) and arithmetic coding are out of
scope — callers fall back to PIL for those (io/images.py).

Design: the entropy scan is the only serial part (a per-symbol Python
walk over canonical Huffman max-code tables); everything downstream —
dequantization, the 8x8 inverse DCT (one einsum over all blocks), chroma
upsampling, and the YCbCr->RGB matrix — is vectorized numpy over every
block in the image at once.
"""

from __future__ import annotations

import numpy as np

# Zig-zag order: scan position -> (row, col) flat index in the 8x8 block.
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8x8 IDCT basis: pixel[x] = sum_u C[u, x] * alpha(u) * coef[u].
_C = np.zeros((8, 8), np.float64)
for _u in range(8):
    for _x in range(8):
        a = np.sqrt(0.5) if _u == 0 else 1.0
        _C[_u, _x] = 0.5 * a * np.cos((2 * _x + 1) * _u * np.pi / 16.0)


class JpegError(ValueError):
    pass


class _Huffman:
    """Canonical Huffman table (T.81 annex C): decode by length-indexed
    min/max code comparison — at most 16 compares per symbol."""

    def __init__(self, counts, symbols):
        self.symbols = symbols
        self.mincode = np.zeros(17, np.int64)
        self.maxcode = np.full(17, -1, np.int64)
        self.valptr = np.zeros(17, np.int64)
        code = 0
        k = 0
        for length in range(1, 17):
            # int(): counts is often a uint8 array and `code += n` would
            # silently wrap the accumulating code at 256, corrupting every
            # code longer than 8 bits.
            n = int(counts[length - 1])
            if n:
                self.valptr[length] = k
                self.mincode[length] = code
                self.maxcode[length] = code + n - 1
                code += n
                k += n
            code <<= 1


class _BitReader:
    """MSB-first bit reader over the byte-unstuffed entropy segment."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                # Past the end: pad with 1-bits (T.81 F.2.2.5 allows the
                # final code to be completed by padding).
                self.acc = (self.acc << 8) | 0xFF
            else:
                self.acc = (self.acc << 8) | self.data[self.pos]
                self.pos += 1
            self.nbits += 8

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def decode(self, tab: _Huffman) -> int:
        if self.nbits < 16:
            self._fill()
        code = 0
        for length in range(1, 17):
            self.nbits -= 1
            code = (code << 1) | ((self.acc >> self.nbits) & 1)
            if code <= tab.maxcode[length]:
                self.acc &= (1 << self.nbits) - 1
                return int(
                    tab.symbols[tab.valptr[length] + code - tab.mincode[length]]
                )
        raise JpegError("invalid Huffman code")


def _extend(v: int, n: int) -> int:
    """T.81 F.2.2.1: map the n received magnitude bits to a signed value."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "td", "ta", "dc_pred", "blocks",
                 "bw", "bh")


def decode(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG -> uint8 [H, W, C] (C = 1 or 3, RGB)."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")
    pos = 2
    qt: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _Huffman] = {}
    huff_ac: dict[int, _Huffman] = {}
    comps: list[_Component] = []
    width = height = 0
    hmax = vmax = 1
    restart_interval = 0
    progressive = False

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            continue  # standalone markers
        seg_len = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + seg_len]
        pos += seg_len

        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 0xF
                p += 1
                if pq:
                    tbl = np.frombuffer(seg[p:p + 128], ">u2").astype(np.int32)
                    p += 128
                else:
                    tbl = np.frombuffer(seg[p:p + 64], np.uint8).astype(np.int32)
                    p += 64
                q = np.zeros(64, np.int32)
                q[ZIGZAG] = tbl  # de-zigzag into natural order
                qt[tq] = q
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0xF
                counts = np.frombuffer(seg[p + 1:p + 17], np.uint8)
                n = int(counts.sum())
                symbols = np.frombuffer(seg[p + 17:p + 17 + n], np.uint8)
                (huff_ac if tc else huff_dc)[th] = _Huffman(counts, symbols)
                p += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            progressive = marker == 0xC2
            if progressive:
                raise JpegError("progressive JPEG (SOF2) not supported")
            if seg[0] != 8:
                raise JpegError(f"unsupported sample precision {seg[0]}")
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            ncomp = seg[5]
            for i in range(ncomp):
                c = _Component()
                c.cid = seg[6 + 3 * i]
                c.h = seg[7 + 3 * i] >> 4
                c.v = seg[7 + 3 * i] & 0xF
                c.tq = seg[8 + 3 * i]
                c.dc_pred = 0
                comps.append(c)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
        elif marker == 0xDD:  # DRI
            restart_interval = int.from_bytes(seg[:2], "big")
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan_comps = []
            for i in range(ns):
                cid = seg[1 + 2 * i]
                c = next(c for c in comps if c.cid == cid)
                c.td = seg[2 + 2 * i] >> 4
                c.ta = seg[2 + 2 * i] & 0xF
                scan_comps.append(c)
            # Entropy-coded data follows until the next non-RST marker.
            scan_start = pos
            end = scan_start
            while end < len(data) - 1:
                if data[end] == 0xFF and data[end + 1] not in (0x00,) and not (
                    0xD0 <= data[end + 1] <= 0xD7
                ):
                    break
                end += 1
            _decode_scan(
                data[scan_start:end], scan_comps, comps, huff_dc, huff_ac,
                width, height, hmax, vmax, restart_interval,
            )
            pos = end
        elif marker == 0xD9:  # EOI
            break
        # APPn / COM / others: skipped via seg_len

    if not comps or width == 0:
        raise JpegError("no frame decoded")
    return _reconstruct(comps, qt, width, height, hmax, vmax)


def _decode_scan(raw, scan_comps, comps, huff_dc, huff_ac, width, height,
                 hmax, vmax, restart_interval):
    """Baseline interleaved (or single-component) scan: fills each
    component's zig-zag coefficient array, one 8x8 block per row."""
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    interleaved = len(scan_comps) > 1
    for c in comps:
        if interleaved:
            c.bw, c.bh = mcux * c.h, mcuy * c.v
        else:
            c.bw = -(-(width * c.h // hmax) // 8)
            c.bh = -(-(height * c.v // vmax) // 8)
        c.blocks = np.zeros((c.bh * c.bw, 64), np.int32)

    # Byte-unstuff and split at RST markers in one pass.
    segments = []
    cur = bytearray()
    i = 0
    while i < len(raw):
        b = raw[i]
        if b == 0xFF:
            nxt = raw[i + 1] if i + 1 < len(raw) else 0xD9
            if nxt == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:
                segments.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            break
        cur.append(b)
        i += 1
    segments.append(bytes(cur))

    def decode_block(reader, c, out):
        s = reader.decode(huff_dc[c.td])
        diff = _extend(reader.bits(s), s)
        c.dc_pred += diff
        out[0] = c.dc_pred
        k = 1
        ac = huff_ac[c.ta]
        while k < 64:
            rs = reader.decode(ac)
            r, s = rs >> 4, rs & 0xF
            if s == 0:
                if r == 15:
                    k += 16  # ZRL
                    continue
                break  # EOB
            k += r
            if k > 63:
                raise JpegError("AC run past block end")
            out[k] = _extend(reader.bits(s), s)
            k += 1

    n_mcu = (mcux * mcuy) if interleaved else (
        scan_comps[0].bw * scan_comps[0].bh
    )
    mcu = 0
    seg_idx = 0
    reader = _BitReader(segments[0])
    per_seg = restart_interval if restart_interval else n_mcu
    while mcu < n_mcu:
        if mcu and restart_interval and mcu % per_seg == 0:
            seg_idx += 1
            reader = _BitReader(segments[seg_idx])
            for c in comps:
                c.dc_pred = 0
        if interleaved:
            my, mx = divmod(mcu, mcux)
            for c in scan_comps:
                for by in range(c.v):
                    for bx in range(c.h):
                        row = my * c.v + by
                        col = mx * c.h + bx
                        decode_block(reader, c, c.blocks[row * c.bw + col])
        else:
            c = scan_comps[0]
            decode_block(reader, c, c.blocks[mcu])
        mcu += 1


def _reconstruct(comps, qt, width, height, hmax, vmax):
    """Vectorized dequantize + IDCT + upsample + color transform."""
    planes = []
    for c in comps:
        q = qt[c.tq]
        coefs = np.zeros((c.blocks.shape[0], 64), np.int64)
        coefs[:, ZIGZAG] = c.blocks  # zig-zag scan -> natural order
        coefs = coefs * q[None, :].astype(np.int64)
        blocks = coefs.reshape(-1, 8, 8).astype(np.float64)
        # pixels = C^T (over u/rows) . block . C (over v/cols)
        pix = np.einsum("ux,nuv,vy->nxy", _C, blocks, _C) + 128.0
        plane = (
            pix.reshape(c.bh, c.bw, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(c.bh * 8, c.bw * 8)
        )
        # Upsample to full resolution (pixel replication, like stb's
        # default-quality path) and crop to the frame size.
        ry, rx = vmax // c.v, hmax // c.h
        if ry > 1 or rx > 1:
            plane = np.repeat(np.repeat(plane, ry, axis=0), rx, axis=1)
        planes.append(plane[:height, :width])

    if len(planes) == 1:
        out = planes[0][..., None]
    elif len(planes) == 3:
        y, cb, cr = planes
        cb = cb - 128.0
        cr = cr - 128.0
        out = np.stack(
            [
                y + 1.402 * cr,
                y - 0.344136 * cb - 0.714136 * cr,
                y + 1.772 * cb,
            ],
            axis=-1,
        )
    else:
        raise JpegError(f"unsupported component count {len(planes)}")
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Minimal baseline encoder (4:4:4, quality-scaled Annex K tables). The
# reference never encodes JPEG (stb_image is decode-only); this exists so
# scene generators can embed JPEG textures without any external library,
# and as the roundtrip half of the decoder's tests.
# ---------------------------------------------------------------------------

# Annex K.1/K.2 quantization tables (natural order via ZIGZAG below).
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int32)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.int32)

# Annex K.3 typical Huffman tables: (BITS counts, HUFFVAL symbols).
_H_DC_LUMA = (
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
    list(range(12)),
)
_H_DC_CHROMA = (
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    list(range(12)),
)
_H_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
        0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
        0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
        0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
        0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
        0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
        0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
        0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
        0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
        0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
    ],
)
_H_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
        0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
        0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
        0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
        0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
        0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
        0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
        0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
        0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
        0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
        0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
        0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
        0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
    ],
)


def _enc_codes(table):
    """(counts, symbols) -> {symbol: (code, length)} canonical assignment."""
    counts, symbols = table
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, length: int):
        self.acc = (self.acc << length) | code
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)


def _quality_scale(q: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling (same curve as libjpeg/stb)."""
    quality = min(max(int(quality), 1), 100)
    s = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((q * s + 50) // 100, 1, 255).astype(np.int32)


def encode(img: np.ndarray, quality: int = 90) -> bytes:
    """Encode uint8 [H, W] / [H, W, 1] / [H, W, 3] as baseline JPEG
    (4:4:4, Annex K Huffman tables)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    gray = nch == 1
    f = img.astype(np.float64)
    if gray:
        planes = [f[..., 0]]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0,
        ]

    qy = _quality_scale(_Q_LUMA, quality)
    qc = _quality_scale(_Q_CHROMA, quality)
    bh, bw = -(-h // 8), -(-w // 8)

    def to_blocks(plane, q):
        p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
        blocks = (
            p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
            - 128.0
        )
        # forward DCT: coef = C . pixels . C^T (the exact transpose of the
        # decoder's IDCT einsum)
        coef = np.einsum("ux,nxy,vy->nuv", _C, blocks, _C)
        quant = np.round(coef.reshape(-1, 64) / q.reshape(1, 64)).astype(np.int32)
        return quant[:, ZIGZAG]  # natural -> zigzag scan order

    zz = [to_blocks(planes[0], qy)]
    for p in planes[1:]:
        zz.append(to_blocks(p, qc))

    dc_codes = [_enc_codes(_H_DC_LUMA), _enc_codes(_H_DC_CHROMA)]
    ac_codes = [_enc_codes(_H_AC_LUMA), _enc_codes(_H_AC_CHROMA)]

    bw_ = _BitWriter()
    preds = [0] * len(planes)
    n_blocks = bh * bw
    for bi in range(n_blocks):
        for ci in range(len(planes)):
            tid = 0 if ci == 0 else 1
            block = zz[ci][bi]
            diff = int(block[0]) - preds[ci]
            preds[ci] = int(block[0])
            mag = int(abs(diff)).bit_length()
            code, length = dc_codes[tid][mag]
            bw_.write(code, length)
            if mag:
                v = diff if diff >= 0 else diff + (1 << mag) - 1
                bw_.write(v & ((1 << mag) - 1), mag)
            run = 0
            last_nz = 0
            nz = np.nonzero(block[1:])[0]
            last_nz = (int(nz[-1]) + 1) if len(nz) else 0
            for k in range(1, last_nz + 1):
                v = int(block[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    code, length = ac_codes[tid][0xF0]
                    bw_.write(code, length)
                    run -= 16
                mag = abs(v).bit_length()
                code, length = ac_codes[tid][(run << 4) | mag]
                bw_.write(code, length)
                u = v if v >= 0 else v + (1 << mag) - 1
                bw_.write(u & ((1 << mag) - 1), mag)
                run = 0
            if last_nz < 63:
                code, length = ac_codes[tid][0x00]
                bw_.write(code, length)
    bw_.flush()

    def seg(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    def dqt(tid, q):
        return seg(0xDB, bytes([tid]) + bytes(q[ZIGZAG].astype(np.uint8)))

    def dht(tc, th, table):
        counts, symbols = table
        return seg(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols))

    ncomp = 1 if gray else 3
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([ncomp])
    sos = bytes([ncomp])
    for ci in range(ncomp):
        tq = 0 if ci == 0 else 1
        sof += bytes([ci + 1, 0x11, tq])  # 1x1 sampling: 4:4:4
        sos += bytes([ci + 1, (tq << 4) | tq])
    sos += bytes([0, 63, 0])  # baseline spectral selection

    out = bytearray(b"\xff\xd8")
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += dqt(0, qy)
    if not gray:
        out += dqt(1, qc)
    out += seg(0xC0, sof)
    out += dht(0, 0, _H_DC_LUMA) + dht(1, 0, _H_AC_LUMA)
    if not gray:
        out += dht(0, 1, _H_DC_CHROMA) + dht(1, 1, _H_AC_CHROMA)
    out += seg(0xDA, sos)
    out += bw_.out
    out += b"\xff\xd9"
    return bytes(out)
