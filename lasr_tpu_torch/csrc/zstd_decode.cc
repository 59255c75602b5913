// A zstd frame decoder (RFC 8878) for the orbax checkpoint reader
// (lasr_tpu_torch/utils/ocdbt.py): orbax writes every OCDBT node and
// every zarr chunk as a zstd frame, and the machines the port runs on
// need not have a zstd library.  A host decoder, not a GPU kernel.
//
// Covers the whole format but dictionaries: raw, RLE and compressed
// blocks; raw, RLE, Huffman and treeless literals in 1- and 4-stream
// form; sequences in predefined, RLE, FSE and repeat modes with the
// repeat offsets; skippable frames, several frames in one buffer, the
// window size and the XXH64 content checksum.  A frame naming a
// dictionary, and any corrupt or truncated input, fail with a message;
// every read is bounds-checked.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zstd_decode.cc -o libzstd_decode.so
// (utils/zstd.py builds it into lasr_tpu_torch/_build/ at first use).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Error {
  const char* msg;
};

[[noreturn]] void fail(const char* msg) { throw Error{msg}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---- XXH64 (the frame's content checksum is its low 32 bits) ----

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- the output buffer ----

// Grows by doubling, or, over a caller's buffer (owned false), holds to
// its capacity.
struct Out {
  uint8_t* buf = nullptr;
  size_t size = 0, cap = 0;
  bool owned = true;
  ~Out() {
    if (owned) free(buf);
  }
  void reserve(size_t need) {
    if (need <= cap) return;
    if (!owned) fail("content larger than the expected size");
    size_t c = cap ? cap : 1 << 16;
    while (c < need) c *= 2;
    uint8_t* b = static_cast<uint8_t*>(realloc(buf, c));
    if (!b) fail("out of memory");
    buf = b;
    cap = c;
  }
  uint8_t* grow(size_t n) {
    reserve(size + n);
    uint8_t* p = buf + size;
    size += n;
    return p;
  }
};

// ---- bit readers ----

// Forward, least significant bit first (FSE table descriptions).  A
// peek past the end reads 0 bits; the caller checks bytes() <= n.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  FwdBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int nb) const {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = pos + i;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward: the stream is read from its last bit towards its first, past
// the 1-bit marker that ends the last byte.  Bits below the start read
// as 0 and drive `left` negative, which callers check.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t left = 0;  // bits not yet read
  void init(const uint8_t* p_, size_t n_) {
    p = p_;
    n = n_;
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream without its end marker");
    left = int64_t(8 * (n - 1)) + highbit(last);
  }
  // bits [lo, lo+nb) of the stream as a little-endian number, nb <= 56
  uint64_t bits(int64_t lo, int nb) const {
    if (nb == 0) return 0;
    if (lo < 0) {
      int high = nb + int(lo);
      return high <= 0 ? 0 : bits(0, high) << (-lo);
    }
    size_t byte = size_t(lo >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      v = le64(p + byte);
    } else {
      for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (v >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t read(int nb) {
    left -= nb;
    return bits(left, nb);
  }
  uint64_t peek(int nb) const { return bits(left - nb, nb); }
};

// ---- FSE ----

struct FseCell {
  uint16_t sym;
  uint8_t nb;
  uint16_t base;
};

struct Fse {
  int log = -1;  // -1: no table yet
  std::vector<FseCell> t;
};

void build_fse(Fse& f, const int16_t* norm, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  f.log = log;
  f.t.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("corrupt FSE distribution");
      f.t[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].sym = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("corrupt FSE distribution");
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[f.t[u].sym]++;
    if (x == 0) fail("corrupt FSE distribution");
    int nb = log - highbit(x);
    f.t[u].nb = uint8_t(nb);
    f.t[u].base = uint16_t((x << nb) - size);
  }
}

// Reads an FSE table description; returns the bytes it took.
size_t read_fse(Fse& f, const uint8_t* p, size_t n, int max_sym, int max_log) {
  FwdBits bits(p, n);
  int log = int(bits.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym || bits.bytes() > n)
      fail("corrupt FSE table description");
    int max = 2 * threshold - 1 - remaining;
    int v = int(bits.peek(nb));
    int count;
    if ((v & (threshold - 1)) < max) {
      count = v & (threshold - 1);
      bits.pos += nb - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= max;
      bits.pos += nb;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail("corrupt FSE table description");
    norm[sym++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int rep = int(bits.read(2));
        sym += rep;
        if (sym > max_sym + 1) fail("corrupt FSE table description");
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (bits.bytes() > n) fail("truncated FSE table description");
  build_fse(f, norm, sym, log);
  return bits.bytes();
}

void rle_fse(Fse& f, int sym) {
  f.log = 0;
  f.t.assign(1, FseCell{uint16_t(sym), 0, 0});
}

// ---- Huffman literals ----

struct Huf {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint8_t> sym, nb;
};

size_t read_huf(Huf& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("truncated Huffman tree description");
  uint8_t w[256] = {0};
  int nw = 0;
  size_t used;
  int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail("truncated Huffman tree description");
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(head);
    if (used > n || head == 0) fail("truncated Huffman tree description");
    Fse f;
    size_t t = read_fse(f, p + 1, head, 255, 6);
    if (t >= size_t(head)) fail("corrupt Huffman tree description");
    BackBits b;
    b.init(p + 1 + t, head - t);
    uint32_t s1 = uint32_t(b.read(f.log)), s2 = uint32_t(b.read(f.log));
    if (b.left < 0) fail("corrupt Huffman tree description");
    uint32_t* st[2] = {&s1, &s2};
    for (int k = 0;; k ^= 1) {
      if (nw >= 255) fail("corrupt Huffman tree description");
      const FseCell& c = f.t[*st[k]];
      w[nw++] = uint8_t(c.sym);
      *st[k] = c.base + uint32_t(b.read(c.nb));
      if (b.left < 0) {
        if (nw >= 255) fail("corrupt Huffman tree description");
        w[nw++] = uint8_t(f.t[*st[k ^ 1]].sym);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("corrupt Huffman weights");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("corrupt Huffman weights");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("corrupt Huffman weights");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("corrupt Huffman weights");
  w[nw++] = uint8_t(highbit(rest) + 1);
  h.max_bits = max_bits;
  size_t size = size_t(1) << max_bits, pos = 0;
  h.sym.assign(size, 0);
  h.nb.assign(size, 0);
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != weight) continue;
      size_t len = size_t(1) << (weight - 1);
      if (pos + len > size) fail("corrupt Huffman weights");
      memset(&h.sym[pos], s, len);
      memset(&h.nb[pos], max_bits + 1 - weight, len);
      pos += len;
    }
  }
  if (pos != size) fail("corrupt Huffman weights");
  return used;
}

void huf_stream(const Huf& h, const uint8_t* p, size_t n, uint8_t* out,
                size_t count) {
  BackBits b;
  b.init(p, n);
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = uint32_t(b.peek(h.max_bits));
    out[i] = h.sym[v];
    b.left -= h.nb[v];
    if (b.left < 0) fail("corrupt Huffman stream");
  }
  if (b.left != 0) fail("corrupt Huffman stream");
}

// ---- sequences: the code tables and predefined distributions ----

const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64,  128, 256, 512,  1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1,  1,  2,  2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---- a frame's decoding state ----

constexpr size_t BLOCK_MAX = 128 * 1024;

struct Frame {
  Out& out;
  size_t start;         // where this frame's output begins
  uint64_t window;
  Huf huf;
  Fse ll, of, ml;       // the previous block's tables (repeat mode)
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
  Frame(Out& o, size_t s, uint64_t w) : out(o), start(s), window(w) {}

  // the literals section; returns the bytes it took
  size_t literals(const uint8_t* p, size_t n) {
    if (n < 1) fail("truncated literals section");
    int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    size_t regen, csize = 0, head;
    if (type < 2) {
      if ((fmt & 1) == 0) {
        head = 1;
        regen = p[0] >> 3;
      } else if (fmt == 1) {
        head = 2;
        if (n < 2) fail("truncated literals section");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        head = 3;
        if (n < 3) fail("truncated literals section");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      lit.resize(regen);
      if (type == 0) {
        if (head + regen > n) fail("truncated raw literals");
        memcpy(lit.data(), p + head, regen);
        return head + regen;
      }
      if (head + 1 > n) fail("truncated RLE literals");
      memset(lit.data(), p[head], regen);
      return head + 1;
    }
    int width = fmt < 2 ? 10 : (fmt == 2 ? 14 : 18);
    head = fmt < 2 ? 3 : (fmt == 2 ? 4 : 5);
    if (n < head) fail("truncated literals section");
    uint64_t h = 0;
    for (size_t i = 0; i < head; ++i) h |= uint64_t(p[i]) << (8 * i);
    regen = size_t((h >> 4) & ((1u << width) - 1));
    csize = size_t((h >> (4 + width)) & ((1u << width) - 1));
    if (regen > BLOCK_MAX) fail("literals larger than a block");
    if (head + csize > n) fail("truncated compressed literals");
    const uint8_t* q = p + head;
    size_t qn = csize;
    if (type == 2) {
      size_t t = read_huf(huf, q, qn);
      q += t;
      qn -= t;
    } else if (huf.max_bits == 0) {
      fail("treeless literals without an earlier Huffman table");
    }
    lit.resize(regen);
    if (fmt == 0) {
      huf_stream(huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("truncated literal jump table");
      size_t s[4] = {size_t(q[0]) | size_t(q[1]) << 8,
                     size_t(q[2]) | size_t(q[3]) << 8,
                     size_t(q[4]) | size_t(q[5]) << 8, 0};
      if (s[0] + s[1] + s[2] + 6 > qn) fail("corrupt literal jump table");
      s[3] = qn - 6 - s[0] - s[1] - s[2];
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("corrupt literals section");
      const uint8_t* r = q + 6;
      for (int k = 0; k < 4; ++k) {
        size_t cnt = k < 3 ? seg : regen - 3 * seg;
        huf_stream(huf, r, s[k], lit.data() + k * seg, cnt);
        r += s[k];
      }
    }
    return head + csize;
  }

  void table(Fse& f, int mode, const uint8_t*& p, const uint8_t* end,
             const int16_t* def, int def_n, int def_log, int max_sym,
             int max_log) {
    if (mode == 0) {
      build_fse(f, def, def_n, def_log);
    } else if (mode == 1) {
      if (p >= end) fail("truncated sequences section");
      if (*p > max_sym) fail("corrupt RLE sequence code");
      rle_fse(f, *p++);
    } else if (mode == 2) {
      p += read_fse(f, p, size_t(end - p), max_sym, max_log);
    } else if (f.log < 0) {
      fail("repeat mode without an earlier table");
    }
  }

  void copy_match(size_t offset, size_t len) {
    size_t have = out.size - start;
    if (offset == 0 || offset > have || offset > window)
      fail("match offset beyond the window");
    uint8_t* dst = out.grow(len);
    const uint8_t* src = dst - offset;
    if (offset >= len) {
      memcpy(dst, src, len);
    } else {
      for (size_t i = 0; i < len; ++i) dst[i] = src[i];
    }
  }

  void block(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    size_t block_start = out.size;
    p += literals(p, n);
    if (p >= end) fail("truncated sequences section");
    size_t nseq = *p++;
    if (nseq >= 128) {
      if (nseq == 255) {
        if (end - p < 2) fail("truncated sequences section");
        nseq = p[0] + (size_t(p[1]) << 8) + 0x7F00;
        p += 2;
      } else {
        if (p >= end) fail("truncated sequences section");
        nseq = ((nseq - 128) << 8) + *p++;
      }
    }
    const uint8_t* litp = lit.data();
    size_t lit_left = lit.size();
    if (nseq == 0) {
      if (p != end) fail("bytes after an empty sequences section");
      memcpy(out.grow(lit_left), litp, lit_left);
      return;
    }
    if (p >= end) fail("truncated sequences section");
    int modes = *p++;
    if (modes & 3) fail("reserved sequence mode bits set");
    table(ll, modes >> 6, p, end, LL_DEFAULT, 36, 6, 35, 9);
    table(of, (modes >> 4) & 3, p, end, OF_DEFAULT, 29, 5, 31, 8);
    table(ml, (modes >> 2) & 3, p, end, ML_DEFAULT, 53, 6, 52, 9);
    if (p >= end) fail("truncated sequence bitstream");
    BackBits b;
    b.init(p, size_t(end - p));
    uint32_t sl = uint32_t(b.read(ll.log)), so = uint32_t(b.read(of.log)),
             sm = uint32_t(b.read(ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      if (b.left < 0) fail("corrupt sequence bitstream");
      const FseCell &cl = ll.t[sl], &co = of.t[so], &cm = ml.t[sm];
      int ofc = co.sym;
      uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
      size_t mlen = ML_BASE[cm.sym] + b.read(ML_BITS[cm.sym]);
      size_t llen = LL_BASE[cl.sym] + b.read(LL_BITS[cl.sym]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 1 ? rep[1] : idx == 2 ? rep[2] : uint64_t(rep[0]) - 1;
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        sl = cl.base + uint32_t(b.read(cl.nb));
        sm = cm.base + uint32_t(b.read(cm.nb));
        so = co.base + uint32_t(b.read(co.nb));
      }
      if (llen > lit_left) fail("sequence takes more literals than exist");
      memcpy(out.grow(llen), litp, llen);
      litp += llen;
      lit_left -= llen;
      if (out.size - block_start + mlen > BLOCK_MAX)
        fail("block decodes to more than 128 KiB");
      copy_match(size_t(offset), mlen);
    }
    if (b.left != 0) fail("corrupt sequence bitstream");
    memcpy(out.grow(lit_left), litp, lit_left);
  }
};

// Decodes one frame at p; returns the bytes it took.
size_t frame(const uint8_t* p, size_t n, Out& out) {
  const uint8_t* q = p + 4;
  const uint8_t* end = p + n;
  if (q >= end) fail("truncated frame header");
  int fhd = *q++;
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  int dict_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set");
  uint64_t window = 0;
  if (!single) {
    if (q >= end) fail("truncated frame header");
    int wd = *q++;
    int exponent = wd >> 3, mantissa = wd & 7;
    if (exponent > 31) fail("window too large");
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int DICT_BYTES[4] = {0, 1, 2, 4};
  static const int FCS_BYTES[4] = {0, 2, 4, 8};
  int db = DICT_BYTES[dict_flag];
  int fb = fcs_flag == 0 ? single : FCS_BYTES[fcs_flag];
  if (end - q < db + fb) fail("truncated frame header");
  uint64_t dict = 0, fcs = 0;
  for (int i = 0; i < db; ++i) dict |= uint64_t(q[i]) << (8 * i);
  q += db;
  for (int i = 0; i < fb; ++i) fcs |= uint64_t(q[i]) << (8 * i);
  q += fb;
  if (fb == 2) fcs += 256;
  if (dict) fail("frame needs a dictionary");
  if (single) window = fcs;
  size_t start = out.size;
  if (fb && fcs <= (uint64_t(n) << 10)) out.reserve(start + size_t(fcs));
  Frame f(out, start, window);
  for (;;) {
    if (end - q < 3) fail("truncated block header");
    uint32_t bh = q[0] | uint32_t(q[1]) << 8 | uint32_t(q[2]) << 16;
    q += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > BLOCK_MAX) fail("block larger than 128 KiB");
    if (type == 1) {
      if (q >= end) fail("truncated RLE block");
      memset(out.grow(size), *q++, size);
    } else {
      if (size_t(end - q) < size) fail("truncated block");
      if (type == 0) {
        memcpy(out.grow(size), q, size);
      } else {
        f.block(q, size);
      }
      q += size;
    }
    if (last) break;
  }
  size_t produced = out.size - start;
  if (fb && produced != fcs) fail("frame content size mismatch");
  if (checksum) {
    if (end - q < 4) fail("truncated content checksum");
    uint32_t want = le32(q);
    q += 4;
    if (uint32_t(xxh64(out.buf + start, produced, 0)) != want)
      fail("content checksum mismatch");
  }
  return size_t(q - p);
}

void decompress(const uint8_t* p, size_t n, Out& out) {
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("truncated frame");
    uint32_t magic = le32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("truncated skippable frame");
      uint64_t size = le32(p + pos + 4);
      if (size > n - pos - 8) fail("truncated skippable frame");
      pos += 8 + size_t(size);
    } else if (magic == 0xFD2FB528u) {
      pos += frame(p + pos, n - pos, out);
    } else {
      fail("not a zstd frame");
    }
  }
}

void set_error(char* err, size_t cap, const char* msg) {
  if (!cap) return;
  size_t len = strlen(msg);
  if (len >= cap) len = cap - 1;
  memcpy(err, msg, len);
  err[len] = 0;
}

}  // namespace

extern "C" {

// Decodes every frame of src[0, n) into a malloc'd buffer (*out, freed
// with lasr_zstd_free) and returns its length, or -1 with a message in
// err[0, errcap).
int64_t lasr_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t** out,
                             char* err, uint64_t errcap) {
  *out = nullptr;
  try {
    Out o;
    decompress(src, size_t(n), o);
    if (!o.buf) o.reserve(1);
    *out = o.buf;
    int64_t size = int64_t(o.size);
    o.buf = nullptr;
    return size;
  } catch (const Error& e) {
    set_error(err, size_t(errcap), e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, size_t(errcap), "out of memory");
  }
  return -1;
}

// Decodes every frame of src[0, n) into dst[0, cap) and returns the
// content's length, or -1 with a message in err[0, errcap) (content
// longer than cap among them).
int64_t lasr_zstd_decompress_into(const uint8_t* src, uint64_t n,
                                  uint8_t* dst, uint64_t cap, char* err,
                                  uint64_t errcap) {
  try {
    Out o;
    o.buf = dst;
    o.cap = size_t(cap);
    o.owned = false;
    decompress(src, size_t(n), o);
    return int64_t(o.size);
  } catch (const Error& e) {
    set_error(err, size_t(errcap), e.msg);
  }
  return -1;
}

void lasr_zstd_free(uint8_t* p) { free(p); }

}  // extern "C"
