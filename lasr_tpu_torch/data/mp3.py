"""MPEG-1/2/2.5 Audio Layer III (mp3) decoder over numpy (counterpart of
``lasr_tpu/data/mp3.py``, of which it is a copy; the port imports nothing
of the JAX package).

The reference ingests mp3 through librosa / audioread (ffmpeg or mad,
``lasr/data/reader.py:23-29``); this first-party decoder needs neither,
and it is the path of ``read_audio('*.mp3')``.

Coverage: MPEG-1 (32/44.1/48 kHz) and MPEG-2/2.5 LSF (8-24 kHz) Layer
III, mono/stereo/dual/joint (MS stereo; MPEG-1 AND LSF intensity stereo
for long blocks, validated sample-by-sample against libmpg123 on
hand-crafted frames; short-block intensity falls back to MS/LR),
long/short/mixed blocks, all Huffman tables, bit reservoir, block
switching, alias reduction, IMDCT + polyphase synthesis.  Layers I/II
are out of scope (".mp3" corpora are Layer III).

``lasr_tpu``'s copy is validated against libmp3lame-encoded fixtures
decoded by libmpg123 (``tests/test_mp3.py``); this one is held equal to
it (``tests/test_torch_port_codecs.py``).  Standard-defined constant
tables live in ``_mp3tables.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from lasr_tpu_torch.data._mp3tables import (
    ALIAS, COUNT1, HUFF_BIG, HUFF_SHAPE, INTWINBASE, LINBITS, PRETAB,
    SFB_LONG, SFB_SHORT)

_BITRATE_V1 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
               256, 320]
_BITRATE_V2 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
               160]
_RATES = {3: [44100, 48000, 32000], 2: [22050, 24000, 16000],
          0: [11025, 12000, 8000]}


class Mp3Error(ValueError):
    pass


# ------------------------------------------------------------------ bits

class _Bits:
    """MSB-first bit reader."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            # corrupt/truncated frame: surface as Mp3Error so the frame
            # loop's skip-bad-frame handler catches it (an IndexError
            # would crash the whole file read)
            raise Mp3Error("bitstream exhausted")
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def read1(self) -> int:
        if self.pos >= 8 * len(self.data):
            raise Mp3Error("bitstream exhausted")
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit


# ------------------------------------------------------ huffman decoding

def _build_tree(codes, lens):
    """(len, code) -> symbol dict for MSB-first incremental decode."""
    return {(int(n), int(c)): i for i, (c, n) in enumerate(zip(codes,
                                                               lens))}


_BIG_LOOKUP = {t: _build_tree(*HUFF_BIG[t]) for t in HUFF_BIG}
_C1_LOOKUP = {t: _build_tree(*COUNT1[t]) for t in COUNT1}
_MAXLEN_BIG = {t: max(HUFF_BIG[t][1]) for t in HUFF_BIG}


def _huff_symbol(bits: _Bits, lookup, maxlen: int) -> int:
    code = 0
    for n in range(1, maxlen + 1):
        code = (code << 1) | bits.read1()
        sym = lookup.get((n, code))
        if sym is not None:
            return sym
    raise Mp3Error("invalid huffman code")


# --------------------------------------------------------- side info

class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "wsf", "block_type", "mixed",
                 "table_select", "subblock_gain", "region0", "region1",
                 "preflag", "scalefac_scale", "count1table_select",
                 "scalefac_l", "scalefac_s")


def _read_side_info(data: bytes, mpeg1: bool, nch: int):
    bits = _Bits(data)
    main_data_begin = bits.read(9 if mpeg1 else 8)
    bits.read((5 if nch == 1 else 3) if mpeg1 else
              (1 if nch == 1 else 2))
    scfsi = [[0] * 4 for _ in range(nch)]
    if mpeg1:
        for ch in range(nch):
            for b in range(4):
                scfsi[ch][b] = bits.read1()
    ngr = 2 if mpeg1 else 1
    granules = []
    for _ in range(ngr):
        chs = []
        for _ in range(nch):
            g = _Granule()
            g.part2_3_length = bits.read(12)
            g.big_values = bits.read(9)
            g.global_gain = bits.read(8)
            g.scalefac_compress = bits.read(4 if mpeg1 else 9)
            g.wsf = bits.read1()
            if g.wsf:
                g.block_type = bits.read(2)
                g.mixed = bits.read1()
                g.table_select = [bits.read(5), bits.read(5), 0]
                g.subblock_gain = [bits.read(3) for _ in range(3)]
                # implicit regions (ISO 2.4.2.7): region0 ends at 36
                # (long-sfb 8 for block_type!=2 w/ wsf; 36 covers both)
                g.region0, g.region1 = 7, 13
                if g.block_type == 0:
                    raise Mp3Error("wsf with block_type 0")
            else:
                g.block_type = 0
                g.mixed = 0
                g.table_select = [bits.read(5) for _ in range(3)]
                g.subblock_gain = [0, 0, 0]
                g.region0 = bits.read(4)
                g.region1 = bits.read(3)
            g.preflag = bits.read1() if mpeg1 else 0
            g.scalefac_scale = bits.read1()
            g.count1table_select = bits.read1()
            chs.append(g)
        granules.append(chs)
    return main_data_begin, scfsi, granules


# ------------------------------------------------------- scalefactors

_SLEN1 = [0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4]
_SLEN2 = [0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3]

# LSF scalefactor group sizes (ISO 13818-3 2.4.3.2): [long, short, mixed]
_LSF_NSFB = {
    "long": [[6, 5, 5, 5], [6, 5, 7, 3], [11, 10, 0, 0]],
    "short": [[9, 9, 9, 9], [9, 9, 12, 6], [18, 18, 0, 0]],
    "mixed": [[6, 9, 9, 9], [6, 9, 12, 6], [15, 18, 0, 0]],
}

# ... and the three extra partitions used by the INTENSITY channel
# (ISO 13818-3 2.4.3.2 intensity_stereo case; the transmitted values are
# intensity positions, selected by scalefac_compress >> 1)
_LSF_NSFB_INT = {
    "long": [[7, 7, 7, 0], [6, 6, 6, 3], [8, 8, 5, 0]],
    "short": [[12, 12, 12, 0], [12, 9, 9, 6], [15, 12, 9, 0]],
    "mixed": [[6, 15, 12, 0], [6, 12, 9, 6], [6, 18, 9, 0]],
}


def _read_scalefactors_v1(bits, g: _Granule, scfsi_ch, gr: int,
                          prev: Optional[_Granule]):
    g.scalefac_l = [0] * 23
    g.scalefac_s = [[0] * 3 for _ in range(13)]
    s1, s2 = _SLEN1[g.scalefac_compress], _SLEN2[g.scalefac_compress]
    if g.wsf and g.block_type == 2:
        if g.mixed:
            for sfb in range(8):
                g.scalefac_l[sfb] = bits.read(s1)
            for sfb in range(3, 6):
                for w in range(3):
                    g.scalefac_s[sfb][w] = bits.read(s1)
        else:
            for sfb in range(6):
                for w in range(3):
                    g.scalefac_s[sfb][w] = bits.read(s1)
        for sfb in range(6, 12):
            for w in range(3):
                g.scalefac_s[sfb][w] = bits.read(s2)
    else:
        groups = [(0, 6, s1), (6, 11, s1), (11, 16, s2), (16, 21, s2)]
        for b, (lo, hi, slen) in enumerate(groups):
            if gr == 1 and scfsi_ch[b]:
                for sfb in range(lo, hi):
                    g.scalefac_l[sfb] = prev.scalefac_l[sfb]
            else:
                for sfb in range(lo, hi):
                    g.scalefac_l[sfb] = bits.read(slen)


def _read_scalefactors_lsf(bits, g: _Granule, is_intensity_ch: bool):
    sfc = g.scalefac_compress
    if g.wsf and g.block_type == 2:
        kind = "mixed" if g.mixed else "short"
    else:
        kind = "long"
    if is_intensity_ch:
        # intensity channel: the value groups carry intensity POSITIONS,
        # partitioned by scalefac_compress >> 1 (bit 0 is
        # intensity_scale, consumed by _stereo_intensity)
        sfc >>= 1
        if sfc < 180:
            slen = [sfc // 36, (sfc % 36) // 6, sfc % 6, 0]
            nsfb = _LSF_NSFB_INT[kind][0]
        elif sfc < 244:
            c = sfc - 180
            slen = [(c >> 4) & 3, (c >> 2) & 3, c & 3, 0]
            nsfb = _LSF_NSFB_INT[kind][1]
        else:
            c = sfc - 244
            slen = [c // 3, c % 3, 0, 0]
            nsfb = _LSF_NSFB_INT[kind][2]
        g.preflag = 0
    elif sfc < 400:
        slen = [(sfc >> 4) // 5, (sfc >> 4) % 5, (sfc >> 2) & 3, sfc & 3]
        nsfb = _LSF_NSFB[kind][0]
        g.preflag = 0
    elif sfc < 500:
        c = sfc - 400
        slen = [(c >> 2) // 5, (c >> 2) % 5, c & 3, 0]
        nsfb = _LSF_NSFB[kind][1]
        g.preflag = 0
    else:
        c = sfc - 500
        slen = [c // 3, c % 3, 0, 0]
        nsfb = _LSF_NSFB[kind][2]
        g.preflag = 1
    raw = []
    for grp in range(4):
        for _ in range(nsfb[grp]):
            raw.append(bits.read(slen[grp]))
    g.scalefac_l = [0] * 23
    g.scalefac_s = [[0] * 3 for _ in range(13)]
    if kind == "long":
        for i, v in enumerate(raw[:22]):
            g.scalefac_l[i] = v
    elif kind == "short":
        for sfb in range(12):
            for w in range(3):
                g.scalefac_s[sfb][w] = raw[sfb * 3 + w]
    else:   # mixed: 6 long sfbs then short sfbs 3..11
        for i in range(6):
            g.scalefac_l[i] = raw[i]
        k = 6
        for sfb in range(3, 12):
            for w in range(3):
                g.scalefac_s[sfb][w] = raw[k]
                k += 1
    return


# --------------------------------------------------- huffman main data

def _decode_spectrum(bits, g: _Granule, limit: int, rate: int,
                     mpeg1: bool):
    """Decode 576 quantized values; returns int32 array.  ``limit`` is the
    absolute bit position where part2_3 data ends."""
    is_ = np.zeros(576, np.int32)
    sfb_l = SFB_LONG[rate]
    if g.wsf:
        # implicit region boundary, in the rate's own sfb units: short
        # blocks end region0 after 9 window-sfbs (= sfb_short[3]*3
        # lines), start/stop blocks after 8 long sfbs (= sfb_long[8]).
        # Both give the classic 36 for every MPEG-1 rate; LSF long
        # tables give 54 (108 at 8 kHz), and 8 kHz short gives 72 —
        # verified bit-exact against libmpg123 output (tests/test_mp3.py)
        if g.block_type == 2:
            region1_start = SFB_SHORT[rate][3] * 3
        else:
            region1_start = sfb_l[8]
        region2_start = 576
    else:
        region1_start = sfb_l[min(g.region0 + 1, 22)]
        region2_start = sfb_l[min(g.region0 + 1 + g.region1 + 1, 22)]
    idx = 0
    nbig = g.big_values * 2
    for start, end, tsel in ((0, min(nbig, region1_start),
                              g.table_select[0]),
                             (region1_start, min(nbig, region2_start),
                              g.table_select[1]),
                             (region2_start, nbig, g.table_select[2])):
        if end <= start:
            continue
        idx = start
        if tsel == 0 or tsel in (4, 14):
            idx = end
            continue
        base = ALIAS.get(tsel, tsel)
        lookup = _BIG_LOOKUP[base]
        maxlen = _MAXLEN_BIG[base]
        rows = HUFF_SHAPE[base]
        linbits = LINBITS.get(tsel, 0)
        while idx < end:
            sym = _huff_symbol(bits, lookup, maxlen)
            x, y = sym // rows, sym % rows
            if x == 15 and linbits:
                x += bits.read(linbits)
            if x:
                if bits.read1():
                    x = -x
            if y == 15 and linbits:
                y += bits.read(linbits)
            if y:
                if bits.read1():
                    y = -y
            is_[idx] = x
            is_[idx + 1] = y
            idx += 2
    # count1 region
    lookup = _C1_LOOKUP[g.count1table_select]
    maxlen = max(COUNT1[g.count1table_select][1])
    total_bits = len(bits.data) * 8
    while bits.pos < limit and idx <= 572:
        mark = bits.pos
        if bits.pos + maxlen + 4 > total_bits:
            break
        sym = _huff_symbol(bits, lookup, maxlen)
        quad = ((sym >> 3) & 1, (sym >> 2) & 1, (sym >> 1) & 1, sym & 1)
        vals = []
        for q in quad:
            if q and bits.read1():
                q = -q
            vals.append(q)
        if bits.pos > limit:
            bits.pos = mark   # last quadruple straddled the boundary
            break
        is_[idx: idx + 4] = vals
        idx += 4
    if bits.pos > limit:
        raise Mp3Error("huffman data overran part2_3_length")
    bits.pos = limit          # skip stuffing bits
    return is_


# --------------------------------------------------------- requantize

_POW43 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)


def _requantize(is_, g: _Granule, rate: int, mpeg1: bool):
    xr = np.zeros(576, np.float64)
    mag = _POW43[np.abs(is_)]
    sign = np.sign(is_).astype(np.float64)
    sf_mult = 0.5 * (1 + g.scalefac_scale)
    sfb_l = SFB_LONG[rate]
    sfb_s = SFB_SHORT[rate]
    gg = g.global_gain - 210

    if not (g.wsf and g.block_type == 2):
        # pure long
        exps = np.zeros(576)
        for sfb in range(22):
            lo, hi = sfb_l[sfb], sfb_l[sfb + 1]
            pre = PRETAB[sfb] if g.preflag else 0
            exps[lo:hi] = 0.25 * gg - sf_mult * (g.scalefac_l[sfb] + pre)
        xr = sign * mag * np.exp2(exps)
        return xr

    # short (possibly mixed): spectrum is in (sfb, window, line) order
    exps = np.zeros(576)
    pos = 0
    if g.mixed:
        # long region of a mixed block: first 8 long sfbs (MPEG-1) or 6
        # (LSF); both end exactly at sfb_s[3]*3 lines (36, or 72 at
        # 8 kHz), where the short region picks up — the same split
        # _reorder_short and _imdct_granule use
        long_end = sfb_s[3] * 3
        for sfb in range(8 if mpeg1 else 6):
            lo, hi = sfb_l[sfb], min(sfb_l[sfb + 1], long_end)
            if lo >= long_end:
                break
            pre = PRETAB[sfb] if g.preflag else 0
            exps[lo:hi] = 0.25 * gg - sf_mult * (g.scalefac_l[sfb] + pre)
        pos = long_end
        first_short_sfb = 3
    else:
        first_short_sfb = 0
    for sfb in range(first_short_sfb, 13):
        width = sfb_s[sfb + 1] - sfb_s[sfb]
        for w in range(3):
            if pos >= 576:
                break
            n = min(width, 576 - pos)
            sf = g.scalefac_s[sfb][w] if sfb < 12 else 0
            exps[pos: pos + n] = 0.25 * (gg - 8 * g.subblock_gain[w]) \
                - sf_mult * sf
            pos += n
    xr = sign * mag * np.exp2(exps)
    return xr


def _reorder_short(xr, g: _Granule, rate: int):
    """Map (sfb, window, line) order to (subband, window, line) order:
    18-sample subband chunks of [w0 l0..5 | w1 l0..5 | w2 l0..5]."""
    if not (g.wsf and g.block_type == 2):
        return xr
    sfb_s = SFB_SHORT[rate]
    out = xr.copy()
    start_sfb = 3 if g.mixed else 0
    start_line = sfb_s[start_sfb] * 3   # 36 for mixed, 0 otherwise
    src = start_line
    for sfb in range(start_sfb, 13):
        width = sfb_s[sfb + 1] - sfb_s[sfb]
        for w in range(3):
            for line in range(width):
                j = sfb_s[sfb] + line        # line index within a window
                dst = (j // 6) * 18 + w * 6 + (j % 6)
                if src < 576 and dst < 576:
                    out[dst] = xr[src]
                src += 1
    return out


# ------------------------------------------------------------- stereo

def _ms_stereo(xr_l, xr_r):
    s = 1.0 / math.sqrt(2.0)
    m, sd = xr_l.copy(), xr_r.copy()
    return (m + sd) * s, (m - sd) * s


def _intensity_factors(is_pos: int, lsf: bool, intensity_scale: int):
    """(left, right) reconstruction factors for one intensity band.

    MPEG-1 (ISO 11172-3 2.4.3.4.9.3): ratio = tan(is_pos*pi/12),
    L = v*ratio/(1+ratio), R = v/(1+ratio).  LSF (ISO 13818-3
    2.4.3.2): io = 2^(-(intensity_scale+1)/4); odd positions attenuate
    the LEFT by io^((p+1)/2), even positions the RIGHT by io^(p/2)
    (position 0 copies v to both).  Matches libmpg123's tan1/2_1 and
    pow1/2_1 table construction — the behavioral gate in
    tests/test_mp3.py crafts such frames and compares sample-by-sample.
    """
    if not lsf:
        ratio = math.tan(is_pos * math.pi / 12.0)
        return ratio / (1.0 + ratio), 1.0 / (1.0 + ratio)
    base = 2.0 ** (-0.25 * (intensity_scale + 1))
    if is_pos == 0:
        return 1.0, 1.0
    if is_pos & 1:
        return base ** ((is_pos + 1) // 2), 1.0
    return 1.0, base ** (is_pos // 2)


def _stereo_intensity(xr_l, xr_r, g_r: _Granule, rate: int, ms: bool,
                      lsf: bool):
    """Joint stereo with intensity on: bands below the right channel's
    zero boundary are MS (if mode_ext&2) or plain L/R; bands above carry
    an intensity position in the right channel's scalefactors and
    reconstruct from the LEFT (mid) spectrum.  is_pos == 7 is
    illegal-intensity → those bands fall back to MS/LR (libmpg123
    semantics for both MPEG-1 and LSF; the spec's all-ones rule
    coincides at the common slen=3).  The sfb21 region reuses band 20's
    position (no position of its own is transmitted)."""
    sfb_l = SFB_LONG[rate]
    nz = np.nonzero(xr_r)[0]
    bound = (int(nz[-1]) + 1) if len(nz) else 0
    iscale = g_r.scalefac_compress & 1
    if g_r.wsf and g_r.block_type == 2:
        # short-block intensity unsupported: treat whole granule as MS/LR
        return _ms_stereo(xr_l, xr_r) if ms else (xr_l, xr_r)

    def band(lo, hi, is_pos):
        if lo < bound or is_pos == 7:
            if ms:
                xr_l[lo:hi], xr_r[lo:hi] = _ms_stereo(xr_l[lo:hi],
                                                      xr_r[lo:hi])
            return
        t1, t2 = _intensity_factors(is_pos, lsf, iscale)
        left = xr_l[lo:hi].copy()
        xr_l[lo:hi] = left * t1
        xr_r[lo:hi] = left * t2
    for sfb in range(21):
        band(sfb_l[sfb], sfb_l[sfb + 1], g_r.scalefac_l[sfb])
    band(sfb_l[21], sfb_l[22], g_r.scalefac_l[20])
    return xr_l, xr_r


# ------------------------------------------------- alias / imdct / synth

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
_CA = _CI / np.sqrt(1.0 + _CI * _CI)


def _alias_reduce(xr, n_subbands: int):
    for b in range(1, n_subbands):
        for i in range(8):
            u = xr[18 * b - 1 - i]
            d = xr[18 * b + i]
            xr[18 * b - 1 - i] = u * _CS[i] - d * _CA[i]
            xr[18 * b + i] = d * _CS[i] + u * _CA[i]
    return xr


def _win_long(block_type: int) -> np.ndarray:
    i = np.arange(36)
    if block_type == 0:
        return np.sin(np.pi / 36 * (i + 0.5))
    if block_type == 1:   # start
        w = np.sin(np.pi / 36 * (i + 0.5))
        w[18:24] = 1.0
        w[24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
        w[30:] = 0.0
        return w
    if block_type == 3:   # stop
        w = np.sin(np.pi / 36 * (i + 0.5))
        w[:6] = 0.0
        w[6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
        w[12:18] = 1.0
        return w
    raise Mp3Error("bad long block type")


_WIN = {bt: _win_long(bt) for bt in (0, 1, 3)}
_WIN_SHORT = np.sin(np.pi / 12 * (np.arange(12) + 0.5))

_I36, _K18 = np.meshgrid(np.arange(36), np.arange(18), indexing="ij")
_IMDCT36 = np.cos(np.pi / 72 * (2 * _I36 + 1 + 18) * (2 * _K18 + 1))
_I12, _K6 = np.meshgrid(np.arange(12), np.arange(6), indexing="ij")
_IMDCT12 = np.cos(np.pi / 24 * (2 * _I12 + 1 + 6) * (2 * _K6 + 1))


def _imdct_granule(xr, g: _Granule, store, n_long_sb: int = 2):
    """xr: 576 spectral values (subband-major).  Returns 576 time samples
    (18 per subband) and updates the per-subband overlap ``store``.
    ``n_long_sb``: subbands using the long window in a mixed block
    (sfb_s[3]*3 / 18 — 2 normally, 4 for the 8 kHz LSF tables)."""
    out = np.empty(576)
    for sb in range(32):
        X = xr[18 * sb: 18 * sb + 18]
        short = g.wsf and g.block_type == 2 \
            and (not g.mixed or sb >= n_long_sb)
        if short:
            z = np.zeros(36)
            for w in range(3):
                xw = _IMDCT12 @ X[6 * w: 6 * w + 6]
                z[6 * w + 6: 6 * w + 18] += xw * _WIN_SHORT
        else:
            # start/stop blocks (wsf, block_type 1/3) are long windows;
            # the long subbands of a mixed granule use the normal window
            bt = g.block_type if g.wsf and g.block_type != 2 else 0
            z = (_IMDCT36 @ X) * _WIN[bt]
        out[18 * sb: 18 * sb + 18] = z[:18] + store[sb]
        store[sb] = z[18:]
    return out


def _freq_invert(ts):
    """Odd time samples of odd subbands are negated."""
    v = ts.reshape(32, 18)
    v[1::2, 1::2] *= -1.0
    return v.reshape(576)


# synthesis matrices
_N = np.cos(np.pi / 64.0 * (16 + np.arange(64))[:, None]
            * (2 * np.arange(32) + 1)[None, :])
_half = np.asarray(INTWINBASE, np.float64) / 65536.0
_D = np.empty(512)
_D[:257] = _half
_D[257:] = _half[512 - np.arange(257, 512)]   # mirror: D[i] = half[512-i]
# ISO Table B.3 prints the prototype with every other 64-tap group negated
# (the intwinbase extraction is the unsigned prototype half); verified
# against libmpg123 output to ~1e-7 rms (tests/test_mp3.py)
_D *= np.where((np.arange(512) // 64) % 2 == 1, -1.0, 1.0)
# U-window selection indices (ISO synthesis flowchart)
_U_SEL = np.empty(512, np.intp)
for _i in range(8):
    _U_SEL[_i * 64: _i * 64 + 32] = _i * 128 + np.arange(32)
    _U_SEL[_i * 64 + 32: _i * 64 + 64] = _i * 128 + 96 + np.arange(32)


class _Synth:
    def __init__(self):
        self.v = np.zeros(1024)

    def run(self, S):
        """S: (18, 32) subband samples -> (18, 32) PCM samples."""
        out = np.empty((S.shape[0], 32))
        for t in range(S.shape[0]):
            self.v[64:] = self.v[:-64]
            self.v[:64] = _N @ S[t]
            u = self.v[_U_SEL]
            w = u * _D
            out[t] = w.reshape(16, 32).sum(axis=0)
        return out


# ------------------------------------------------------------ top level

class _FrameHeader:
    __slots__ = ("version", "mpeg1", "bitrate", "rate", "padding",
                 "mode", "mode_ext", "nch", "crc", "frame_bytes",
                 "side_bytes")


def _parse_header(b: bytes) -> Optional[_FrameHeader]:
    if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
        return None
    version = (b[1] >> 3) & 3          # 0: 2.5, 2: 2, 3: 1
    layer = (b[1] >> 1) & 3            # 1 = Layer III
    if version == 1 or layer != 1:
        return None
    h = _FrameHeader()
    h.version = version
    h.mpeg1 = version == 3
    bi = (b[2] >> 4) & 15
    ri = (b[2] >> 2) & 3
    if bi in (0, 15) or ri == 3:
        return None
    h.bitrate = (_BITRATE_V1 if h.mpeg1 else _BITRATE_V2)[bi] * 1000
    h.rate = _RATES[version][ri]
    h.padding = (b[2] >> 1) & 1
    h.crc = not (b[1] & 1)
    h.mode = (b[3] >> 6) & 3
    h.mode_ext = (b[3] >> 4) & 3
    h.nch = 1 if h.mode == 3 else 2
    h.frame_bytes = (144 if h.mpeg1 else 72) * h.bitrate // h.rate \
        + h.padding
    h.side_bytes = (17 if h.nch == 1 else 32) if h.mpeg1 else \
        (9 if h.nch == 1 else 17)
    return h


def _skip_id3(data: bytes, pos: int) -> int:
    if data[pos: pos + 3] == b"ID3" and len(data) >= pos + 10:
        sz = ((data[pos + 6] & 0x7F) << 21) | ((data[pos + 7] & 0x7F)
                                               << 14) \
            | ((data[pos + 8] & 0x7F) << 7) | (data[pos + 9] & 0x7F)
        return pos + 10 + sz
    return pos


def read_mp3(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode an mp3 file → (float32 (n, channels) in [-1, 1], rate)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    pos = _skip_id3(data, 0)
    reservoir = b""
    synths: List[_Synth] = []
    stores = None
    chunks = []
    rate = None
    nch_out = None
    while pos + 4 <= len(data):
        h = _parse_header(data[pos:])
        if h is None or pos + h.frame_bytes > len(data):
            pos += 1
            continue
        # validate next frame begins with sync too (resync robustness)
        nxt = pos + h.frame_bytes
        if nxt + 1 < len(data) and not (data[nxt] == 0xFF
                                        and (data[nxt + 1] & 0xE0)
                                        == 0xE0):
            # allow the final frame
            if nxt < len(data) - 128 - 1:
                pos += 1
                continue
        if rate is None:
            rate, nch_out = h.rate, h.nch
            synths = [_Synth() for _ in range(h.nch)]
            stores = [np.zeros((32, 18)) for _ in range(h.nch)]
        elif h.rate != rate or h.nch != nch_out:
            break   # stream parameter change: stop at first segment
        body = pos + 4 + (2 if h.crc else 0)
        side = data[body: body + h.side_bytes]
        main_data = data[body + h.side_bytes: pos + h.frame_bytes]
        try:
            pcm = _decode_frame(h, side, main_data, reservoir, synths,
                                stores)
            if pcm is not None:
                chunks.append(pcm)
        except Mp3Error:
            pass   # undecodable frame (reservoir warm-up): skip
        reservoir = (reservoir + main_data)[-2048:]
        pos += h.frame_bytes
    if rate is None:
        raise Mp3Error("no Layer III frames found")
    if not chunks:
        raise Mp3Error("no decodable frames")
    pcm = np.concatenate(chunks, axis=0).astype(np.float32)
    return pcm, rate


def _decode_frame(h: _FrameHeader, side: bytes, main_data: bytes,
                  reservoir: bytes, synths, stores):
    main_data_begin, scfsi, granules = _read_side_info(side, h.mpeg1,
                                                       h.nch)
    if main_data_begin > len(reservoir):
        raise Mp3Error("bit reservoir underrun")
    buf = (reservoir[len(reservoir) - main_data_begin:] if
           main_data_begin else b"") + main_data
    bits = _Bits(buf)
    ngr = len(granules)
    out = np.empty((ngr * 576, h.nch), np.float64)
    ms = h.mode == 1 and (h.mode_ext & 2)
    intensity = h.mode == 1 and (h.mode_ext & 1)
    for gr in range(ngr):
        xrs = []
        for ch in range(h.nch):
            g = granules[gr][ch]
            start = bits.pos
            limit = start + g.part2_3_length
            if h.mpeg1:
                _read_scalefactors_v1(
                    bits, g, scfsi[ch], gr,
                    granules[0][ch] if gr == 1 else None)
            else:
                _read_scalefactors_lsf(
                    bits, g, intensity and ch == 1)
            is_ = _decode_spectrum(bits, g, limit, h.rate, h.mpeg1)
            xr = _requantize(is_, g, h.rate, h.mpeg1)
            xr = _reorder_short(xr, g, h.rate)
            xrs.append(xr)
        if h.nch == 2:
            if intensity:
                xrs = list(_stereo_intensity(
                    xrs[0], xrs[1], granules[gr][1], h.rate, ms,
                    lsf=not h.mpeg1))
            elif ms:
                l2, r2 = _ms_stereo(xrs[0], xrs[1])
                xrs = [l2, r2]
        for ch in range(h.nch):
            g = granules[gr][ch]
            xr = xrs[ch]
            mixed_sb = (SFB_SHORT[h.rate][3] * 3) // 18
            if g.wsf and g.block_type == 2 and not g.mixed:
                nal = 0
            elif g.wsf and g.block_type == 2 and g.mixed:
                nal = mixed_sb
            else:
                nal = 32
            if nal:
                xr = _alias_reduce(xr, nal)
            ts = _imdct_granule(xr, g, stores[ch], n_long_sb=mixed_sb)
            ts = _freq_invert(ts)
            pcm = synths[ch].run(ts.reshape(32, 18).T)
            out[gr * 576: (gr + 1) * 576, ch] = pcm.reshape(-1)
    return out


def mp3_info(path) -> Tuple[int, int, int]:
    """Header probe: (sample_rate, channels, total_samples) without a
    full decode (scans frame headers)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = _skip_id3(data, 0)
    rate = nch = None
    samples = 0
    while pos + 4 <= len(data):
        h = _parse_header(data[pos:])
        # apply the same frame-fits and next-frame-sync validation as
        # read_mp3, so probed durations match what decode produces on
        # truncated files / embedded false syncs
        if h is None or pos + h.frame_bytes > len(data):
            pos += 1
            continue
        nxt = pos + h.frame_bytes
        if nxt + 1 < len(data) and not (data[nxt] == 0xFF
                                        and (data[nxt + 1] & 0xE0)
                                        == 0xE0):
            if nxt < len(data) - 128 - 1:   # allow the final frame
                pos += 1
                continue
        if rate is None:
            rate, nch = h.rate, h.nch
        samples += 1152 if h.mpeg1 else 576
        pos += h.frame_bytes
    if rate is None:
        raise Mp3Error("no Layer III frames found")
    return rate, nch, samples
