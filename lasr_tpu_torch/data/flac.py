"""FLAC codec over numpy (counterpart of ``lasr_tpu/data/flac.py``, of
which it is a copy; the port imports nothing of the JAX package).

LibriSpeech, the en recipe's corpus, ships FLAC, and the reference reads
it through soundfile / libsndfile (``lasr/data/reader.py:15-29``); this
first-party decoder needs neither.  ``lasr_tpu``'s native C++ decoder
(``native/wavio.cc``) is not ported: this is the port's only FLAC path.

Scope: the full mandatory decode surface of the FLAC format —
CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits,
both Rice residual methods incl. escape partitions, all four channel
assignments (independent, left/side, right/side, mid/side), fixed and
variable blocking, 8/12/16/20/24-bit sample sizes, CRC-8/16 verification.

A compact encoder (``write_flac``) is included so tests can round-trip
without external tools: it emits CONSTANT, VERBATIM and FIXED+Rice frames
(order picked per block), which exercises every hot decode path.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_CRC8_TABLE = None
_CRC16_TABLE = None


def _crc8_table():
    global _CRC8_TABLE
    if _CRC8_TABLE is None:
        t = np.zeros(256, np.uint8)
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            t[i] = c
        _CRC8_TABLE = t
    return _CRC8_TABLE


def _crc16_table():
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        t = np.zeros(256, np.uint16)
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                    else (c << 1) & 0xFFFF
            t[i] = c
        _CRC16_TABLE = t
    return _CRC16_TABLE


def crc8(data: bytes) -> int:
    t = _crc8_table()
    c = 0
    for b in data:
        c = int(t[c ^ b])
    return c


def crc16(data: bytes) -> int:
    t = _crc16_table()
    c = 0
    for b in data:
        c = int(t[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF))
    return c


class _BitReader:
    """MSB-first bit reader over a byte buffer, with fast unary scans."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        # next set bit at or after i (for unary/Rice quotients)
        ones = np.flatnonzero(self.bits).astype(np.int64)
        self._ones = ones
        self.pos = 0
        self.n = len(self.bits)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.n:
            raise ValueError("flac: bitstream overrun")
        chunk = self.bits[self.pos : self.pos + n]
        self.pos += n
        v = 0
        for b in chunk.tolist():
            v = (v << 1) | b
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def next_one(self) -> int:
        i = np.searchsorted(self._ones, self.pos)
        if i >= len(self._ones):
            raise ValueError("flac: unary overrun")
        return int(self._ones[i])

    def read_unary(self) -> int:
        j = self.next_one()
        q = j - self.pos
        self.pos = j + 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos // 8

    def rice_block(self, count: int, param: int) -> np.ndarray:
        """Decode `count` Rice(param) residuals (zigzagged)."""
        out = np.empty(count, np.int64)
        bits = self.bits
        ones = self._ones
        n_ones = len(ones)
        nbits = len(bits)
        pos = self.pos
        oi = int(np.searchsorted(ones, pos))
        for i in range(count):
            if oi >= n_ones:
                raise ValueError("flac: unary overrun")
            j = int(ones[oi])
            q = j - pos
            pos = j + 1
            oi += 1
            r = 0
            if param:
                if pos + param > nbits:
                    raise ValueError("flac: bitstream overrun")
                for b in bits[pos : pos + param].tolist():
                    r = (r << 1) | b
                pos += param
                # advance the ones cursor past the remainder bits
                while oi < len(ones) and ones[oi] < pos:
                    oi += 1
            v = (q << param) | r
            out[i] = (v >> 1) ^ -(v & 1)
        self.pos = pos
        return out


def _read_utf8_coded(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(n - 1):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: bad UTF-8 coded number")
        v = (v << 6) | (b & 0x3F)
    return v


BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
               8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
               13: 8192, 14: 16384, 15: 32768}
SAMPLE_RATES = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class FlacInfo:
    __slots__ = ("sample_rate", "channels", "bits", "total_samples",
                 "data_offset")

    def __init__(self, sample_rate, channels, bits, total_samples,
                 data_offset):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.total_samples = total_samples
        self.data_offset = data_offset

    @property
    def duration(self) -> float:
        return self.total_samples / self.sample_rate if self.sample_rate \
            else 0.0


def parse_streaminfo(data: bytes) -> FlacInfo:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    off = 4
    info = None
    while True:
        hdr = data[off : off + 4]
        if len(hdr) < 4:
            raise ValueError("flac: truncated metadata")
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        length = (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
        body = data[off + 4 : off + 4 + length]
        if btype == 0:  # STREAMINFO
            sr = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
            ch = ((body[12] >> 1) & 0x7) + 1
            bits = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            total = ((body[13] & 0x0F) << 32) | struct.unpack(
                ">I", body[14:18])[0]
            info = (sr, ch, bits, total)
        off += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("flac: no STREAMINFO")
    return FlacInfo(*info, data_offset=off)


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if stype == 0:  # CONSTANT
        x = np.full(blocksize, br.read_signed(bps), np.int64)
    elif stype == 1:  # VERBATIM
        x = np.array([br.read_signed(bps) for _ in range(blocksize)], np.int64)
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        x = _decode_predicted(br, blocksize, bps, order,
                              FIXED_COEFFS[order], 0)
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid qlp precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        x = _decode_predicted(br, blocksize, bps, order, coefs, shift,
                              warmup=warm)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    return x << wasted if wasted else x


def _decode_predicted(br: _BitReader, blocksize: int, bps: int, order: int,
                      coefs, shift: int, warmup=None) -> np.ndarray:
    if warmup is None:
        warmup = [br.read_signed(bps) for _ in range(order)]
    res = _decode_residual(br, blocksize, order)
    c = list(coefs)
    if order == 0:
        return res.copy()
    if shift == 0 and order <= 4 and c == FIXED_COEFFS.get(order, None):
        # fixed predictors: the order-n fixed predictor is the n-th order
        # integrator of the residual; integrate with the warmup's leading
        # j-th differences as the constants of integration
        w = np.asarray(warmup, np.int64)
        leads = []
        for _ in range(order):
            leads.append(int(w[0]))
            w = np.diff(w)
        cur = res[order:]
        for j in range(order - 1, -1, -1):
            cur = np.cumsum(np.concatenate([[leads[j]], cur]))
        return cur
    x = np.empty(blocksize, np.int64)
    x[:order] = warmup
    for i in range(order, blocksize):
        pred = 0
        for j in range(order):
            pred += c[j] * int(x[i - 1 - j])
        x[i] = int(res[i]) + (pred >> shift)
    return x


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts:
        raise ValueError("flac: bad partition order")
    out = np.empty(blocksize, np.int64)
    out[:order] = 0
    idx = order
    for p in range(nparts):
        count = blocksize // nparts - (order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            nbits = br.read(5)
            vals = np.array([br.read_signed(nbits) if nbits else 0
                             for _ in range(count)], np.int64)
            out[idx : idx + count] = vals
        else:
            out[idx : idx + count] = br.rice_block(count, param)
        idx += count
    res = np.empty(blocksize, np.int64)
    res[:] = out
    return res


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file → (float waveform in [-1, 1], sample_rate).

    Mono → (N,); multi-channel → (N, C) (the soundfile layout, so
    ``avgchannel`` applies unchanged)."""
    with open(path, "rb") as f:
        data = f.read()
    info = parse_streaminfo(data)
    br = _BitReader(data[info.data_offset:])
    chans: List[List[np.ndarray]] = [[] for _ in range(info.channels)]
    total = 0
    while True:
        # byte-aligned frame sync
        br.align()
        if br.pos + 16 > br.n:
            break
        if info.total_samples and total >= info.total_samples:
            break
        frame_start = br.byte_pos()
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError("flac: lost frame sync")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_coded(br)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps = info.bits if ss_code == 0 else SAMPLE_SIZES[ss_code]
        hdr_end = br.byte_pos()
        expect = crc8(data[info.data_offset + frame_start :
                           info.data_offset + hdr_end])
        if br.read(8) != expect:
            raise ValueError("flac: frame header CRC mismatch")

        if ch_code < 8:
            nch = ch_code + 1
            subs = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
        elif ch_code == 8:   # left/side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:   # right/side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            subs = [side + right, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            m2 = (mid << 1) | (side & 1)
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"flac: reserved channel assignment {ch_code}")
        if len(subs) != info.channels:
            raise ValueError("flac: channel count mismatch")
        br.align()
        crc_end = br.byte_pos()
        expect16 = crc16(data[info.data_offset + frame_start :
                              info.data_offset + crc_end])
        if br.read(16) != expect16:
            raise ValueError("flac: frame CRC-16 mismatch")
        for c in range(info.channels):
            chans[c].append(subs[c])
        total += blocksize

    sig = np.stack([np.concatenate(c) for c in chans], axis=-1)
    if info.total_samples:
        sig = sig[: info.total_samples]
    wav = sig.astype(np.float64) / float(1 << (info.bits - 1))
    if info.channels == 1:
        wav = wav[:, 0]
    return wav, info.sample_rate


def flac_info(path: str) -> FlacInfo:
    with open(path, "rb") as f:
        head = f.read(65536)
    return parse_streaminfo(head)


# ---------------------------------------------------------------- encoder


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value: int, n: int):
        if n == 0:
            return
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.out.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def bytes(self) -> bytes:
        assert self.nacc == 0
        return bytes(self.out)


def _utf8_coded(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (5 * nbytes + 1)) and nbytes < 7:
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _best_rice_param(res: np.ndarray, pbits: int) -> int:
    if len(res) == 0:
        return 0
    zig = (np.abs(res.astype(np.int64)) << 1) - (res < 0)
    mean = max(float(np.mean(zig)), 0.1)
    k = max(0, int(np.floor(np.log2(mean))))
    return min(k, (1 << pbits) - 2)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int):
    x = x.astype(np.int64)
    if np.all(x == x[0]):
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    # pick the fixed order (0-2) with the smallest residual energy
    best, best_res, best_cost = 0, x, float(np.mean(np.abs(x)))
    cur = x
    for order in (1, 2):
        cur = np.diff(cur)
        if len(cur) == 0:
            break
        cost = float(np.mean(np.abs(cur)))
        if cost < best_cost and len(x) > order:
            best, best_cost = order, cost
            best_res = np.concatenate([np.zeros(order, np.int64), cur])
    order, res = best, best_res
    max_res = int(np.max(np.abs(res))) if len(res) else 0
    if max_res >= (1 << 30):  # rice would blow up; verbatim
        bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
        for v in x.tolist():
            bw.write_signed(v, bps)
        return
    bw.write(0, 1); bw.write(8 + order, 6); bw.write(0, 1)
    for v in x[:order].tolist():
        bw.write_signed(v, bps)
    # residual: method 0 (4-bit rice), partition order 0
    bw.write(0, 2)
    bw.write(0, 4)
    param = _best_rice_param(res[order:], 4)
    bw.write(param, 4)
    for v in res[order:].tolist():
        zz = (v << 1) ^ (v >> 63)
        bw.write_unary(zz >> param)
        bw.write(zz & ((1 << param) - 1), param)


def _encode_subframe_lpc(bw: _BitWriter, x: np.ndarray, bps: int,
                         order: int, prec: int = 12, shift: int = 9):
    """LPC subframe with fixed simple coefficients (decode-path coverage:
    the python/native decoders must invert arbitrary LPC, and real FLAC
    encoders emit mostly LPC frames).  Coefficients approximate a
    second-order smoother, quantized at `prec` bits / `shift`."""
    x = x.astype(np.int64)
    base = {1: [1.0], 2: [1.9, -0.92], 3: [2.2, -1.6, 0.38],
            4: [2.3, -2.0, 0.85, -0.14]}[order]
    coefs = [int(round(c * (1 << shift))) for c in base]
    lim = 1 << (prec - 1)
    coefs = [max(-lim, min(lim - 1, c)) for c in coefs]
    res = np.zeros(len(x), np.int64)
    for i in range(order, len(x)):
        pred = 0
        for j in range(order):
            pred += coefs[j] * int(x[i - 1 - j])
        res[i] = int(x[i]) - (pred >> shift)
    if len(x) <= order or int(np.max(np.abs(res[order:]))) >= (1 << 30):
        bw.write(0, 1); bw.write(1, 6); bw.write(0, 1)
        for v in x.tolist():
            bw.write_signed(v, bps)
        return
    bw.write(0, 1); bw.write(32 | (order - 1), 6); bw.write(0, 1)
    for v in x[:order].tolist():
        bw.write_signed(v, bps)
    bw.write(prec - 1, 4)
    bw.write_signed(shift, 5)
    for c in coefs:
        bw.write_signed(c, prec)
    bw.write(1, 2)  # method 1: 5-bit rice params
    bw.write(0, 4)  # partition order 0
    param = _best_rice_param(res[order:], 5)
    bw.write(param, 5)
    for v in res[order:].tolist():
        zz = (v << 1) ^ (v >> 63)
        bw.write_unary(zz >> param)
        bw.write(zz & ((1 << param) - 1), param)


def write_flac(path: str, wav: np.ndarray, sample_rate: int,
               bits: int = 16, blocksize: int = 4096,
               lpc_order: Optional[int] = None):
    """Encode float waveform in [-1,1] (N,) or (N,C) to a FLAC file
    (CONSTANT / FIXED+Rice / VERBATIM subframes — test fixture quality,
    fully spec-conformant).  ``lpc_order`` (1-4) forces LPC subframes with
    5-bit Rice residuals instead, covering the remaining decode paths."""
    x = np.asarray(wav, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    scale = float(1 << (bits - 1))
    pcm = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)

    out = bytearray()
    out += b"fLaC"
    si = bytearray()
    si += struct.pack(">HH", blocksize, blocksize)
    si += b"\x00\x00\x00" * 2  # min/max frame size unknown
    si.append((sample_rate >> 12) & 0xFF)
    si.append((sample_rate >> 4) & 0xFF)
    si.append(((sample_rate & 0xF) << 4) | ((ch - 1) << 1)
              | ((bits - 1) >> 4))
    si.append((((bits - 1) & 0xF) << 4) | ((n >> 32) & 0xF))
    si += struct.pack(">I", n & 0xFFFFFFFF)
    si += b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + bytes(si)

    frame_no = 0
    for start in range(0, n, blocksize):
        block = pcm[start : start + blocksize]
        bs = block.shape[0]
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)  # fixed blocking
        hdr.write(7, 4)  # 16-bit blocksize follows
        hdr.write(0, 4)  # sample rate from streaminfo
        hdr.write(ch - 1, 4)
        hdr.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bits], 3)
        hdr.write(0, 1)
        hdr.align()
        hbytes = bytearray(hdr.bytes())
        hbytes += _utf8_coded(frame_no)
        hbytes += struct.pack(">H", bs - 1)
        hbytes.append(crc8(bytes(hbytes)))

        body = _BitWriter()
        for c in range(ch):
            if lpc_order:
                _encode_subframe_lpc(body, block[:, c], bits, lpc_order)
            else:
                _encode_subframe(body, block[:, c], bits)
        body.align()
        frame = bytes(hbytes) + body.bytes()
        frame += struct.pack(">H", crc16(frame))
        out += frame
        frame_no += 1
    with open(path, "wb") as f:
        f.write(bytes(out))
