// Native audio IO for the lasr_tpu_torch data pipeline (the port's own
// copy of lasr_tpu's native/wavio.cc; a host decoder, not a GPU kernel).
//
// RIFF/WAVE decode (PCM 8/16/24/32-bit and IEEE float 32/64) and a full
// FLAC decoder (all subframe types, Rice methods, channel decorrelations;
// LibriSpeech, the en recipe's corpus, ships FLAC), with channel
// averaging, plus a thread-pooled batch API that decodes a whole batch of
// files in parallel while Python holds no GIL (called via ctypes from
// lasr_tpu_torch/data/native_loader.py).  Dispatch is by magic bytes
// ("RIFF" vs "fLaC"), so mixed corpora work transparently.  Bit-identical
// to the numpy readers in lasr_tpu_torch/data/{reader,flac}.py
// (tests/test_torch_port_native_wire.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread wavio.cc -o libwavio.so
// (native_loader.py builds it into lasr_tpu_torch/_build/ at first use).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavFormat {
  uint16_t audio_format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_size = 0;
  long data_offset = 0;
};

bool parse_header(FILE* f, WavFormat* wf) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  for (;;) {
    unsigned char chunk[8];
    if (fread(chunk, 1, 8, f) != 8) return false;
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      // PCM fmt body is 16 bytes (bits at +14); EXTENSIBLE sub-format is
      // read at +24, so require size >= 26 before that memcpy. A shorter
      // (malformed/truncated) fmt chunk is rejected, never over-read.
      if (size < 16) return false;
      std::vector<unsigned char> body(size);
      if (fread(body.data(), 1, size, f) != size) return false;
      memcpy(&wf->audio_format, body.data(), 2);
      memcpy(&wf->channels, body.data() + 2, 2);
      memcpy(&wf->sample_rate, body.data() + 4, 4);
      memcpy(&wf->bits, body.data() + 14, 2);
      if (wf->audio_format == 0xFFFE && size >= 26)  // EXTENSIBLE
        memcpy(&wf->audio_format, body.data() + 24, 2);
      if (size % 2) fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt) return false;
      wf->data_size = static_cast<long>(size);
      wf->data_offset = ftell(f);
      return true;
    } else {
      fseek(f, size + (size % 2), SEEK_CUR);
    }
  }
}

// Decode + average channels into out[0..max_samples). Returns frame count
// actually written, or -1 on error.
long decode_file(const char* path, float* out, long max_samples,
                 int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavFormat wf;
  if (!parse_header(f, &wf) || wf.channels == 0 || wf.bits == 0) {
    fclose(f);
    return -1;
  }
  *sample_rate = static_cast<int>(wf.sample_rate);
  const int ch = wf.channels;
  const long bytes_per_frame = ch * (wf.bits / 8);
  long frames = wf.data_size / bytes_per_frame;
  if (frames > max_samples) frames = max_samples;

  std::vector<unsigned char> raw(frames * bytes_per_frame);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const unsigned char* p = raw.data();
  const float inv_ch = 1.0f / ch;
  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) {
      const unsigned char* s = p + (i * ch + c) * (wf.bits / 8);
      double v = 0.0;
      if (wf.audio_format == 1) {  // integer PCM
        switch (wf.bits) {
          case 16: {
            int16_t x;
            memcpy(&x, s, 2);
            v = x / 32768.0;
            break;
          }
          case 32: {
            int32_t x;
            memcpy(&x, s, 4);
            v = x / 2147483648.0;
            break;
          }
          case 24: {
            int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
            if (x >= (1 << 23)) x -= (1 << 24);
            v = x / 8388608.0;
            break;
          }
          case 8:
            v = (s[0] - 128.0) / 128.0;
            break;
          default:
            return -1;
        }
      } else if (wf.audio_format == 3) {  // IEEE float
        if (wf.bits == 32) {
          float x;
          memcpy(&x, s, 4);
          v = x;
        } else if (wf.bits == 64) {
          double x;
          memcpy(&x, s, 8);
          v = x;
        } else {
          return -1;
        }
      } else {
        return -1;
      }
      acc += v;
    }
    out[i] = static_cast<float>(acc * inv_ch);
  }
  return frames;
}

// ---------------------------------------------------------------- FLAC

struct FlacInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int64_t total_samples = 0;
  size_t data_offset = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size)
      : data_(data), size_(size), pos_(0) {}

  bool read(int n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) return false;
      int avail = 8 - static_cast<int>(pos_ & 7);
      int take = n < avail ? n : avail;
      uint8_t b = data_[byte];
      v = (v << take) |
          ((b >> (avail - take)) & ((1u << take) - 1));
      pos_ += take;
      n -= take;
    }
    *out = v;
    return true;
  }

  bool read_signed(int n, int64_t* out) {
    uint64_t v;
    if (!read(n, &v)) return false;
    if (n > 0 && (v >> (n - 1)))
      *out = static_cast<int64_t>(v) - (int64_t{1} << n);
    else
      *out = static_cast<int64_t>(v);
    return true;
  }

  bool read_unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      size_t byte = pos_ >> 3;
      if (byte >= size_) return false;
      int bit = 7 - static_cast<int>(pos_ & 7);
      uint8_t rest = data_[byte] & ((1u << (bit + 1)) - 1);
      if (rest == 0) {  // rest of this byte is zeros
        q += bit + 1;
        pos_ += bit + 1;
        continue;
      }
      // find highest set bit position within [0, bit]
      int h = bit;
      while (!((rest >> h) & 1)) --h;
      q += bit - h;
      pos_ += bit - h + 1;
      *out = q;
      return true;
    }
  }

  void align() { pos_ = (pos_ + 7) & ~size_t{7}; }
  size_t byte_pos() const { return pos_ >> 3; }
  size_t bit_pos() const { return pos_; }
  bool eof() const { return (pos_ >> 3) >= size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_;
};

uint8_t flac_crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b)
      c = (c & 0x80) ? static_cast<uint8_t>((c << 1) ^ 0x07)
                     : static_cast<uint8_t>(c << 1);
  }
  return c;
}

uint16_t flac_crc16(const uint8_t* p, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= static_cast<uint16_t>(p[i]) << 8;
    for (int b = 0; b < 8; ++b)
      c = (c & 0x8000) ? static_cast<uint16_t>((c << 1) ^ 0x8005)
                       : static_cast<uint16_t>(c << 1);
  }
  return c;
}

bool parse_streaminfo(const uint8_t* data, size_t size, FlacInfo* info) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t off = 4;
  bool have = false;
  for (;;) {
    if (off + 4 > size) return false;
    bool last = data[off] & 0x80;
    int type = data[off] & 0x7F;
    uint32_t len = (data[off + 1] << 16) | (data[off + 2] << 8) |
                   data[off + 3];
    if (off + 4 + len > size) return false;
    const uint8_t* b = data + off + 4;
    if (type == 0 && len >= 34) {
      info->sample_rate = (b[10] << 12) | (b[11] << 4) | (b[12] >> 4);
      info->channels = ((b[12] >> 1) & 0x7) + 1;
      info->bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      info->total_samples =
          (static_cast<int64_t>(b[13] & 0x0F) << 32) |
          (static_cast<int64_t>(b[14]) << 24) | (b[15] << 16) |
          (b[16] << 8) | b[17];
      have = true;
    }
    off += 4 + len;
    if (last) break;
  }
  info->data_offset = off;
  return have;
}

bool read_utf8_coded(BitReader* br, uint64_t* out) {
  uint64_t b0;
  if (!br->read(8, &b0)) return false;
  if (b0 < 0x80) {
    *out = b0;
    return true;
  }
  int n = 0;
  uint64_t mask = 0x80;
  while (b0 & mask) {
    ++n;
    mask >>= 1;
  }
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n - 1; ++i) {
    uint64_t b;
    if (!br->read(8, &b)) return false;
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residual(BitReader* br, int blocksize, int order,
                     int64_t* res) {
  uint64_t method, porder;
  if (!br->read(2, &method) || method > 1) return false;
  if (!br->read(4, &porder)) return false;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = (1u << pbits) - 1;
  int nparts = 1 << porder;
  if (blocksize % nparts) return false;
  int idx = order;
  for (int p = 0; p < nparts; ++p) {
    int count = blocksize / nparts - (p == 0 ? order : 0);
    if (count < 0 || idx + count > blocksize) return false;
    uint64_t param;
    if (!br->read(pbits, &param)) return false;
    if (param == escape) {
      uint64_t nbits;
      if (!br->read(5, &nbits)) return false;
      for (int i = 0; i < count; ++i) {
        int64_t v = 0;
        if (nbits && !br->read_signed(static_cast<int>(nbits), &v))
          return false;
        res[idx++] = v;
      }
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q;
        uint64_t r = 0;
        if (!br->read_unary(&q)) return false;
        if (param && !br->read(static_cast<int>(param), &r)) return false;
        uint64_t v = (static_cast<uint64_t>(q) << param) | r;
        res[idx++] = static_cast<int64_t>(v >> 1) ^
                     -static_cast<int64_t>(v & 1);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader* br, int blocksize, int bps, int64_t* x,
                     std::vector<int64_t>* scratch) {
  uint64_t pad, stype, wflag;
  if (!br->read(1, &pad) || pad) return false;
  if (!br->read(6, &stype)) return false;
  if (!br->read(1, &wflag)) return false;
  int wasted = 0;
  if (wflag) {
    uint32_t u;
    if (!br->read_unary(&u)) return false;
    wasted = static_cast<int>(u) + 1;
  }
  bps -= wasted;
  if (bps <= 0) return false;
  if (stype == 0) {  // CONSTANT
    int64_t v;
    if (!br->read_signed(bps, &v)) return false;
    for (int i = 0; i < blocksize; ++i) x[i] = v;
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    int order = static_cast<int>(stype) - 8;
    for (int i = 0; i < order; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
    scratch->resize(blocksize);
    int64_t* res = scratch->data();
    if (!decode_residual(br, blocksize, order, res)) return false;
    const int* c = kFixedCoeffs[order];
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += c[j] * x[i - 1 - j];
      x[i] = res[i] + pred;
    }
  } else if (stype >= 32) {  // LPC
    int order = static_cast<int>(stype & 31) + 1;
    for (int i = 0; i < order; ++i)
      if (!br->read_signed(bps, &x[i])) return false;
    uint64_t precm1;
    if (!br->read(4, &precm1) || precm1 == 15) return false;
    int prec = static_cast<int>(precm1) + 1;
    int64_t shift;
    if (!br->read_signed(5, &shift) || shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i)
      if (!br->read_signed(prec, &coefs[i])) return false;
    scratch->resize(blocksize);
    int64_t* res = scratch->data();
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * x[i - 1 - j];
      x[i] = res[i] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
  return true;
}

const int kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, -8, -16,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

// Decode FLAC + average channels into out[0..max_samples). Returns frame
// count written, or -1 on error.
long decode_flac(const uint8_t* data, size_t size, float* out,
                 long max_samples, int* sample_rate) {
  FlacInfo info;
  if (!parse_streaminfo(data, size, &info)) return -1;
  if (info.channels < 1 || info.channels > 8 || info.bits < 4) return -1;
  *sample_rate = static_cast<int>(info.sample_rate);
  BitReader br(data + info.data_offset, size - info.data_offset);
  const double scale = 1.0 / static_cast<double>(int64_t{1} << (info.bits - 1));
  const double inv_ch = 1.0 / info.channels;
  long total = 0;
  std::vector<std::vector<int64_t>> sub(info.channels);
  std::vector<int64_t> scratch;
  while (total < max_samples) {
    br.align();
    if (br.eof()) break;
    if (info.total_samples && total >= info.total_samples) break;
    size_t frame_start = br.byte_pos();
    uint64_t sync;
    if (!br.read(14, &sync)) break;
    if (sync != 0x3FFE) return -1;
    uint64_t resv, strat, bs_code, sr_code, ch_code, ss_code, resv2;
    if (!br.read(1, &resv) || !br.read(1, &strat) ||
        !br.read(4, &bs_code) || !br.read(4, &sr_code) ||
        !br.read(4, &ch_code) || !br.read(3, &ss_code) ||
        !br.read(1, &resv2))
      return -1;
    uint64_t num;
    if (!read_utf8_coded(&br, &num)) return -1;
    int blocksize;
    if (bs_code == 6) {
      uint64_t v;
      if (!br.read(8, &v)) return -1;
      blocksize = static_cast<int>(v) + 1;
    } else if (bs_code == 7) {
      uint64_t v;
      if (!br.read(16, &v)) return -1;
      blocksize = static_cast<int>(v) + 1;
    } else {
      blocksize = kBlockSizes[bs_code];
      if (blocksize <= 0) return -1;
    }
    if (sr_code == 12) {
      uint64_t v;
      if (!br.read(8, &v)) return -1;
    } else if (sr_code == 13 || sr_code == 14) {
      uint64_t v;
      if (!br.read(16, &v)) return -1;
    }
    int bps = ss_code == 0 ? info.bits : kSampleSizes[ss_code];
    if (bps <= 0) return -1;
    size_t hdr_end = br.byte_pos();
    uint64_t crc;
    if (!br.read(8, &crc)) return -1;
    if (crc != flac_crc8(data + info.data_offset + frame_start,
                         hdr_end - frame_start))
      return -1;

    int nch;
    if (ch_code < 8) {
      nch = static_cast<int>(ch_code) + 1;
      if (nch != info.channels) return -1;
      for (int c = 0; c < nch; ++c) {
        sub[c].resize(blocksize);
        if (!decode_subframe(&br, blocksize, bps, sub[c].data(), &scratch))
          return -1;
      }
    } else if (ch_code <= 10) {
      if (info.channels != 2) return -1;
      nch = 2;
      sub[0].resize(blocksize);
      sub[1].resize(blocksize);
      int bps0 = bps + (ch_code == 9 ? 1 : 0);
      int bps1 = bps + (ch_code == 9 ? 0 : 1);
      if (!decode_subframe(&br, blocksize, bps0, sub[0].data(), &scratch))
        return -1;
      if (!decode_subframe(&br, blocksize, bps1, sub[1].data(), &scratch))
        return -1;
      if (ch_code == 8) {  // left/side
        for (int i = 0; i < blocksize; ++i) sub[1][i] = sub[0][i] - sub[1][i];
      } else if (ch_code == 9) {  // side/right
        for (int i = 0; i < blocksize; ++i) sub[0][i] = sub[0][i] + sub[1][i];
      } else {  // mid/side
        for (int i = 0; i < blocksize; ++i) {
          int64_t side = sub[1][i];
          int64_t m2 = (sub[0][i] << 1) | (side & 1);
          sub[0][i] = (m2 + side) >> 1;
          sub[1][i] = (m2 - side) >> 1;
        }
      }
    } else {
      return -1;
    }
    br.align();
    size_t crc_end = br.byte_pos();
    uint64_t crc16v;
    if (!br.read(16, &crc16v)) return -1;
    if (crc16v != flac_crc16(data + info.data_offset + frame_start,
                             crc_end - frame_start))
      return -1;

    long want = blocksize;
    if (info.total_samples && total + want > info.total_samples)
      want = static_cast<long>(info.total_samples - total);
    if (total + want > max_samples) want = max_samples - total;
    for (long i = 0; i < want; ++i) {
      double acc = 0.0;
      for (int c = 0; c < info.channels; ++c)
        acc += static_cast<double>(sub[c][i]) * scale;
      out[total + i] = static_cast<float>(acc * inv_ch);
    }
    total += want;
  }
  return total;
}

long decode_flac_file(const char* path, float* out, long max_samples,
                      int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  return decode_flac(data.data(), data.size(), out, max_samples,
                     sample_rate);
}

// Dispatch on magic bytes: RIFF/WAVE or fLaC.
long decode_any(const char* path, float* out, long max_samples,
                int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4] = {0};
  size_t got = fread(magic, 1, 4, f);
  fclose(f);
  if (got == 4 && memcmp(magic, "fLaC", 4) == 0)
    return decode_flac_file(path, out, max_samples, sample_rate);
  return decode_file(path, out, max_samples, sample_rate);
}

}  // namespace

extern "C" {

long wav_read(const char* path, float* out, long max_samples,
              int* sample_rate) {
  return decode_any(path, out, max_samples, sample_rate);
}

long wav_info(const char* path, int* sample_rate, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return -1;
  }
  if (memcmp(magic, "fLaC", 4) == 0) {
    // STREAMINFO is the mandatory first metadata block; 64 KiB covers it
    std::vector<uint8_t> head(65536);
    fseek(f, 0, SEEK_SET);
    size_t got = fread(head.data(), 1, head.size(), f);
    fclose(f);
    FlacInfo fi;
    if (!parse_streaminfo(head.data(), got, &fi)) return -1;
    *sample_rate = static_cast<int>(fi.sample_rate);
    *channels = fi.channels;
    return static_cast<long>(fi.total_samples);
  }
  fseek(f, 0, SEEK_SET);
  WavFormat wf;
  bool ok = parse_header(f, &wf);
  fclose(f);
  if (!ok || wf.channels == 0 || wf.bits == 0) return -1;
  *sample_rate = static_cast<int>(wf.sample_rate);
  *channels = wf.channels;
  return wf.data_size / (wf.channels * (wf.bits / 8));
}

// Decode n files in parallel into out (n x max_samples, zero-padded).
// lengths[i] = decoded frame count (or -1 on error). Returns 0 on success,
// otherwise the count of failed files.
int wav_read_batch(const char** paths, int n, float* out, long max_samples,
                   int* lengths, int* sample_rates, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + static_cast<long>(i) * max_samples;
      memset(dst, 0, sizeof(float) * max_samples);
      long got = decode_any(paths[i], dst, max_samples, &sample_rates[i]);
      lengths[i] = static_cast<int>(got);
      if (got < 0) failures.fetch_add(1);
    }
  };
  int t = n_threads < 1 ? 1 : n_threads;
  if (t > n) t = n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
