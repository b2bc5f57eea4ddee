// zstd frame decoder (RFC 8878) and CRC-32C, host code for the orbax
// checkpoint reader (core/zstd.py binds it with ctypes; core/ocdbt.py and
// core/orbax_format.py use it).
//
// Tensorstore writes every zarr chunk of an orbax checkpoint, and every
// OCDBT manifest and B+tree node, as a zstd frame; Python's standard library
// has no zstd, and the port links no libzstd. This file decodes whole
// frames:
//
//   * the frame header: window descriptor, single segment, frame content
//     size; a dictionary ID must be 0 (no dictionaries);
//   * raw, RLE and compressed blocks (at most 128 KiB regenerated each);
//   * literals: raw, RLE, Huffman-coded with one stream or four streams
//     behind a jump table, and treeless (the previous block's Huffman
//     table); Huffman weights given directly or FSE-coded;
//   * sequences: literal-length, offset and match-length codes in
//     predefined, RLE, FSE-coded and repeat modes, the three repeat offsets
//     with the literal-length-0 shift;
//   * skippable frames and several frames one after another;
//   * the optional content checksum (the low 32 bits of XXH64), checked.
//
// A corrupt or truncated frame, or one that would overrun the caller's
// buffer, returns a negative code and leaves the reason for
// zd_last_error(); nothing returns short output. Counters of the modes met
// (zd_counters) let a test show which paths a set of frames took.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zstd_decode.cpp -o libzstd_decode.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Error {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Error{what}; }

enum Counter {
  kFrames, kSkippableFrames, kChecksums,
  kBlocksRaw, kBlocksRle, kBlocksCompressed,
  kLitRaw, kLitRle, kLitHuffman1, kLitHuffman4, kLitTreeless,
  kWeightsDirect, kWeightsFse,
  kSeqNone, kSeqPredefined, kSeqRle, kSeqFse, kSeqRepeat,
  kCounterCount
};
std::atomic<long long> g_counts[kCounterCount];

inline void count(Counter c) { g_counts[c].fetch_add(1, std::memory_order_relaxed); }

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

inline int highest_bit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------------------
// XXH64 (seed 0) for the content checksum

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL,
                   P4 = 0x85EBCA77C2B2AE63ULL, P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
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

// ---------------------------------------------------------------------------
// bit readers

// Forward, little-endian: the FSE table descriptions.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i, ++bit) {
      if ((bit >> 3) >= n) fail("FSE table description runs past its section");
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward: Huffman streams, FSE-coded weights and sequences. The stream is
// read from its last byte down; that byte's highest set bit is the start
// marker. `pos` counts the bits not yet read; reading below bit 0 gives
// zeros (only the last Huffman and FSE symbols may do so).
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;

  void init(const uint8_t* src, size_t len) {
    if (len == 0) fail("empty backward bitstream");
    p = src;
    n = len;
    uint8_t last = src[len - 1];
    if (last == 0) fail("backward bitstream has no start marker");
    pos = int64_t(len) * 8 - (8 - highest_bit(last));
  }
  // the `nbits` (<= 56) bits below `pos`, without consuming them
  inline uint64_t peek(int nbits) const {
    if (nbits == 0) return 0;
    int64_t start = pos - nbits;
    if (start >= 0) {
      size_t byte = size_t(start) >> 3;
      uint64_t w;
      if (byte + 8 <= n) {
        w = rd64(p + byte);
      } else {
        w = 0;
        std::memcpy(&w, p + byte, n - byte);
      }
      return (w >> (start & 7)) & ((uint64_t(1) << nbits) - 1);
    }
    // part of the field lies below bit 0: those low bits are zero
    int have = int(pos);
    if (have <= 0) return 0;
    uint64_t w = 0;
    std::memcpy(&w, p, n < 8 ? n : 8);
    return (w & ((uint64_t(1) << have) - 1)) << (nbits - have);
  }
  inline uint64_t read(int nbits) {
    uint64_t v = peek(nbits);
    pos -= nbits;
    return v;
  }
};

// ---------------------------------------------------------------------------
// FSE

struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
};

constexpr int kMaxFseSymbols = 256;

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  size_t size = size_t(1) << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym);
  size_t high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table does not fill its states");
  for (size_t i = 0; i < size; ++i) {
    uint16_t state = next[t.symbol[i]]++;
    t.bits[i] = uint8_t(log - highest_bit(state));
    t.base[i] = uint16_t((uint32_t(state) << t.bits[i]) - size);
  }
}

// An FSE table description at `src`; returns the bytes it took.
size_t fse_read_table(FseTable& t, const uint8_t* src, size_t n, int max_log, int max_symbols) {
  ForwardBits in{src, n};
  int log = 5 + int(in.read(4));
  if (log > max_log) fail("FSE accuracy log over its maximum");
  int32_t remaining = int32_t(1) << log;
  int16_t norm[kMaxFseSymbols];
  int sym = 0;
  while (remaining > 0 && sym < max_symbols) {
    int nbits = highest_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(nbits);
    uint32_t lower = (1u << (nbits - 1)) - 1;
    uint32_t threshold = (1u << nbits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      in.bit -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[sym++] = int16_t(proba);
    if (proba == 0) {
      int repeat = int(in.read(2));
      for (;;) {
        for (int i = 0; i < repeat && sym < max_symbols; ++i) norm[sym++] = 0;
        if (repeat != 3) break;
        repeat = int(in.read(2));
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  size_t used = in.bytes_used();
  if (used > n) fail("FSE table description runs past its section");
  fse_build(t, norm, sym, log);
  return used;
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.symbol.assign(1, symbol);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

// ---------------------------------------------------------------------------
// Huffman

constexpr int kMaxHuffmanBits = 11;

struct HuffmanTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
  bool valid = false;
};

void huffman_build(HuffmanTable& t, const uint8_t* weights, int nweights) {
  // the last symbol's weight is implied: the weights' powers must sum to a
  // power of two
  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] > kMaxHuffmanBits + 1) fail("Huffman weight over its maximum");
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highest_bit(total) + 1;
  if (max_bits > kMaxHuffmanBits) fail("Huffman code longer than 11 bits");
  uint32_t left = (uint32_t(1) << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a code");
  uint8_t w[256];
  std::memcpy(w, weights, size_t(nweights));
  if (nweights >= 256) fail("too many Huffman symbols");
  w[nweights] = uint8_t(highest_bit(left) + 1);
  int nsym = nweights + 1;
  uint8_t nb[256];
  uint32_t rank_count[kMaxHuffmanBits + 2] = {0};
  for (int i = 0; i < nsym; ++i) {
    nb[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    rank_count[nb[i]]++;
  }
  size_t size = size_t(1) << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  uint32_t rank_idx[kMaxHuffmanBits + 2];
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (uint32_t(1) << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("Huffman code overfills its table");
    std::memset(&t.bits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman code does not fill its table");
  for (int i = 0; i < nsym; ++i) {
    if (!nb[i]) continue;
    uint32_t code = rank_idx[nb[i]], len = uint32_t(1) << (max_bits - nb[i]);
    std::memset(&t.symbol[code], i, len);
    rank_idx[nb[i]] += len;
  }
  t.valid = true;
}

// A Huffman tree description at `src`; returns the bytes it took.
size_t huffman_read_table(HuffmanTable& t, const uint8_t* src, size_t n) {
  if (n < 1) fail("truncated Huffman tree description");
  uint8_t header = src[0];
  uint8_t weights[256];
  int nweights = 0;
  size_t used;
  if (header >= 128) {  // 4-bit weights, two a byte
    count(kWeightsDirect);
    nweights = header - 127;
    used = 1 + (size_t(nweights) + 1) / 2;
    if (used > n) fail("truncated Huffman weights");
    for (int i = 0; i < nweights; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {  // FSE-coded weights: two interleaved states over one stream
    count(kWeightsFse);
    used = 1 + size_t(header);
    if (used > n || header == 0) fail("truncated FSE-coded Huffman weights");
    FseTable ft;
    size_t head = fse_read_table(ft, src + 1, header, 6, 255);
    if (head >= header) fail("FSE-coded Huffman weights have no bitstream");
    BackwardBits bits;
    bits.init(src + 1 + head, header - head);
    uint32_t s1 = uint32_t(bits.read(ft.log)), s2 = uint32_t(bits.read(ft.log));
    for (;;) {
      if (nweights > 254) fail("too many Huffman weights");
      weights[nweights++] = ft.symbol[s1];
      s1 = ft.base[s1] + uint32_t(bits.read(ft.bits[s1]));
      if (bits.pos < 0) {
        weights[nweights++] = ft.symbol[s2];
        break;
      }
      if (nweights > 254) fail("too many Huffman weights");
      weights[nweights++] = ft.symbol[s2];
      s2 = ft.base[s2] + uint32_t(bits.read(ft.bits[s2]));
      if (bits.pos < 0) {
        weights[nweights++] = ft.symbol[s1];
        break;
      }
    }
  }
  huffman_build(t, weights, nweights);
  return used;
}

// One Huffman stream of exactly `count` symbols into `out`.
void huffman_stream(const HuffmanTable& t, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackwardBits bits;
  bits.init(src, n);
  const int mb = t.max_bits;
  const uint8_t* sym = t.symbol.data();
  const uint8_t* nb = t.bits.data();
  size_t i = 0;
  // fast path: every peek lies wholly inside the stream
  while (i < count && bits.pos >= int64_t(mb) + 64) {
    int64_t start = bits.pos - 56;
    uint64_t w = rd64(bits.p + (size_t(start) >> 3)) >> (start & 7);  // 57+ valid bits, top at pos
    int avail = 56;
    while (avail >= mb && i < count) {
      uint32_t idx = uint32_t(w >> (avail - mb)) & ((1u << mb) - 1);
      out[i++] = sym[idx];
      avail -= nb[idx];
    }
    bits.pos -= 56 - avail;
  }
  while (i < count) {
    if (bits.pos <= 0) fail("Huffman stream ends before its symbols");
    uint32_t idx = uint32_t(bits.peek(mb));
    out[i++] = sym[idx];
    bits.pos -= nb[idx];
  }
  if (bits.pos != 0) fail("Huffman stream is not consumed exactly");
}

// ---------------------------------------------------------------------------
// sequences

const int16_t kLlNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMlNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOfNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLlBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMlBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HuffmanTable huffman;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

const FseTable& predefined(int which) {
  static const FseTable* tables = [] {
    static FseTable t[3];
    fse_build(t[0], kLlNorm, 36, 6);
    fse_build(t[1], kOfNorm, 29, 5);
    fse_build(t[2], kMlNorm, 53, 6);
    return t;
  }();
  return tables[which];
}

// One sequence table in mode `mode`; returns the bytes it took.
size_t read_seq_table(FseTable& t, bool& have, int mode, int which, const uint8_t* src, size_t n) {
  static const int max_log[3] = {9, 8, 9}, max_sym[3] = {36, 32, 53};
  switch (mode) {
    case 0:
      count(kSeqPredefined);
      t = predefined(which);
      have = true;
      return 0;
    case 1:
      count(kSeqRle);
      if (n < 1) fail("truncated RLE sequence table");
      if (src[0] >= max_sym[which]) fail("RLE sequence code out of range");
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      count(kSeqFse);
      size_t used = fse_read_table(t, src, n, max_log[which], max_sym[which]);
      have = true;
      return used;
    }
    default:
      count(kSeqRepeat);
      if (!have) fail("repeat-mode sequence table with no earlier table");
      return 0;
  }
}

// ---------------------------------------------------------------------------
// blocks

struct Output {
  uint8_t* base;    // the caller's buffer
  size_t cap;
  size_t pos;       // bytes written so far
  size_t frame_start;
};

inline void need(const Output& o, size_t n) {
  if (n > o.cap - o.pos) fail("decoded data overruns the output buffer");
}

// The literals section at `src`; returns the bytes it took. The literals
// land in fs.literals; `*nlit` is their count.
size_t read_literals(FrameState& fs, const uint8_t* src, size_t n, size_t* nlit) {
  if (n < 1) fail("truncated literals section");
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  size_t regen, comp = 0, head;
  if (type <= 1) {
    if (fmt == 0 || fmt == 2) {
      regen = src[0] >> 3;
      head = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("truncated literals header");
      regen = (src[0] >> 4) | (size_t(src[1]) << 4);
      head = 2;
    } else {
      if (n < 3) fail("truncated literals header");
      regen = (src[0] >> 4) | (size_t(src[1]) << 4) | (size_t(src[2]) << 12);
      head = 3;
    }
    if (regen > (128u << 10)) fail("literals over the block maximum");
    fs.literals.resize(regen);
    if (type == 0) {
      count(kLitRaw);
      if (head + regen > n) fail("truncated raw literals");
      std::memcpy(fs.literals.data(), src + head, regen);
      *nlit = regen;
      return head + regen;
    }
    count(kLitRle);
    if (head + 1 > n) fail("truncated RLE literals");
    std::memset(fs.literals.data(), src[head], regen);
    *nlit = regen;
    return head + 1;
  }
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    if (n < 3) fail("truncated literals header");
    uint32_t h = rd24(src);
    regen = (h >> 4) & 0x3FF;
    comp = (h >> 14) & 0x3FF;
    head = 3;
  } else if (fmt == 2) {
    if (n < 4) fail("truncated literals header");
    uint32_t h = rd32(src);
    regen = (h >> 4) & 0x3FFF;
    comp = h >> 18;
    head = 4;
  } else {
    if (n < 5) fail("truncated literals header");
    uint64_t h = uint64_t(rd32(src)) | (uint64_t(src[4]) << 32);
    regen = (h >> 4) & 0x3FFFF;
    comp = (h >> 22) & 0x3FFFF;
    head = 5;
  }
  if (regen > (128u << 10)) fail("literals over the block maximum");
  if (head + comp > n) fail("truncated compressed literals");
  const uint8_t* p = src + head;
  size_t left = comp;
  if (type == 2) {
    size_t used = huffman_read_table(fs.huffman, p, left);
    p += used;
    left -= used;
  } else {
    count(kLitTreeless);
    if (!fs.huffman.valid) fail("treeless literals with no earlier Huffman table");
  }
  count(streams == 1 ? kLitHuffman1 : kLitHuffman4);
  fs.literals.resize(regen);
  uint8_t* out = fs.literals.data();
  if (streams == 1) {
    huffman_stream(fs.huffman, p, left, out, regen);
  } else {
    if (left < 6) fail("truncated literals jump table");
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    if (6 + s1 + s2 + s3 > left) fail("literals jump table runs past its section");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t per = (regen + 3) / 4;
    if (3 * per > regen) fail("too few literals for four streams");
    const uint8_t* q = p + 6;
    huffman_stream(fs.huffman, q, s1, out, per);
    huffman_stream(fs.huffman, q + s1, s2, out + per, per);
    huffman_stream(fs.huffman, q + s1 + s2, s3, out + 2 * per, per);
    huffman_stream(fs.huffman, q + s1 + s2 + s3, s4, out + 3 * per, regen - 3 * per);
  }
  *nlit = regen;
  return head + comp;
}

inline void copy_match(uint8_t* dst, size_t offset, size_t len) {
  const uint8_t* src = dst - offset;
  if (offset >= len) {
    std::memcpy(dst, src, len);
  } else if (offset >= 8) {
    size_t i = 0;
    for (; i + 8 <= len; i += 8) std::memcpy(dst + i, src + i, 8);  // 8 apart: no overlap per step
    for (; i < len; ++i) dst[i] = src[i];
  } else {
    for (size_t i = 0; i < len; ++i) dst[i] = src[i];
  }
}

void decode_compressed_block(FrameState& fs, const uint8_t* src, size_t n, Output& o) {
  size_t nlit = 0;
  size_t used = read_literals(fs, src, n, &nlit);
  const uint8_t* p = src + used;
  size_t left = n - used;
  if (left < 1) fail("truncated sequences section");
  size_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
    left -= 1;
  } else if (nseq < 255) {
    if (left < 2) fail("truncated sequence count");
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    if (left < 3) fail("truncated sequence count");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  const uint8_t* lit = fs.literals.data();
  size_t lit_pos = 0;
  size_t block_start = o.pos;
  if (nseq == 0) {
    count(kSeqNone);
    if (left != 0) fail("bytes after a block without sequences");
    need(o, nlit);
    std::memcpy(o.base + o.pos, lit, nlit);
    o.pos += nlit;
    return;
  }
  if (left < 1) fail("truncated sequence modes");
  uint8_t modes = p[0];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  p += 1;
  left -= 1;
  size_t t;
  t = read_seq_table(fs.ll, fs.have_ll, modes >> 6, 0, p, left);
  p += t;
  left -= t;
  t = read_seq_table(fs.of, fs.have_of, (modes >> 4) & 3, 1, p, left);
  p += t;
  left -= t;
  t = read_seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, 2, p, left);
  p += t;
  left -= t;
  BackwardBits bits;
  bits.init(p, left);
  uint32_t sll = uint32_t(bits.read(fs.ll.log)), sof = uint32_t(bits.read(fs.of.log)),
           sml = uint32_t(bits.read(fs.ml.log));
  uint32_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    uint8_t llc = fs.ll.symbol[sll], ofc = fs.of.symbol[sof], mlc = fs.ml.symbol[sml];
    if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
    uint32_t ofv = (uint32_t(1) << ofc) + uint32_t(bits.read(ofc));
    size_t ml = kMlBase[mlc] + size_t(bits.read(kMlBits[mlc]));
    size_t ll = kLlBase[llc] + size_t(bits.read(kLlBits[llc]));
    uint32_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = fs.ll.base[sll] + uint32_t(bits.read(fs.ll.bits[sll]));
      sml = fs.ml.base[sml] + uint32_t(bits.read(fs.ml.bits[sml]));
      sof = fs.of.base[sof] + uint32_t(bits.read(fs.of.bits[sof]));
    }
    if (bits.pos < 0) fail("sequences bitstream is too short");
    if (ll > nlit - lit_pos) fail("sequence takes more literals than the block has");
    need(o, ll + ml);
    std::memcpy(o.base + o.pos, lit + lit_pos, ll);
    lit_pos += ll;
    o.pos += ll;
    if (offset == 0 || offset > o.pos - o.frame_start) fail("match offset before the frame's start");
    copy_match(o.base + o.pos, offset, ml);
    o.pos += ml;
  }
  if (bits.pos != 0) fail("sequences bitstream is not consumed exactly");
  size_t rest = nlit - lit_pos;
  need(o, rest);
  std::memcpy(o.base + o.pos, lit + lit_pos, rest);
  o.pos += rest;
  if (o.pos - block_start > (128u << 10)) fail("block regenerates more than 128 KiB");
}

// One frame at `src` (after its magic has been checked); returns the bytes
// the frame took.
size_t decode_frame(const uint8_t* src, size_t n, Output& o) {
  const uint8_t* p = src + 4;
  const uint8_t* end = src + n;
  if (p >= end) fail("truncated frame header");
  uint8_t fhd = *p++;
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    if (p >= end) fail("truncated window descriptor");
    uint8_t wd = *p++;
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t wbase = uint64_t(1) << (10 + exponent);
    window = wbase + (wbase / 8) * mantissa;
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (size_t(end - p) < size_t(did_size[did_flag])) fail("truncated dictionary ID");
  uint32_t did = 0;
  for (int i = 0; i < did_size[did_flag]; ++i) did |= uint32_t(p[i]) << (8 * i);
  p += did_size[did_flag];
  if (did != 0) fail("frame needs a dictionary (ID " + std::to_string(did) + "); none is supported");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (size_t(end - p) < size_t(fcs_size)) fail("truncated frame content size");
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(p[i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  p += fcs_size;
  if (single) window = fcs;
  uint64_t block_max = window < (128u << 10) ? window : (128u << 10);
  o.frame_start = o.pos;
  if (has_fcs && fcs > o.cap - o.pos) fail("frame content size overruns the output buffer");
  FrameState fs;
  for (bool last = false; !last;) {
    if (end - p < 3) fail("truncated block header");
    uint32_t bh = rd24(p);
    p += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      count(kBlocksRle);
      if (p >= end) fail("truncated RLE block");
      if (size > block_max) fail("RLE block over the block maximum");
      need(o, size);
      std::memset(o.base + o.pos, *p, size);
      o.pos += size;
      p += 1;
      continue;
    }
    if (size > size_t(end - p)) fail("truncated block");
    if (size > (type == 0 ? block_max : uint64_t(128u << 10))) fail("block over the block maximum");
    if (type == 0) {
      count(kBlocksRaw);
      need(o, size);
      std::memcpy(o.base + o.pos, p, size);
      o.pos += size;
    } else {
      count(kBlocksCompressed);
      decode_compressed_block(fs, p, size, o);
    }
    p += size;
  }
  size_t produced = o.pos - o.frame_start;
  if (has_fcs && produced != fcs) fail("frame regenerates another size than its header says");
  if (checksum) {
    if (end - p < 4) fail("truncated content checksum");
    uint32_t want = rd32(p);
    p += 4;
    count(kChecksums);
    if (uint32_t(xxh64(o.base + o.frame_start, produced)) != want) fail("content checksum mismatch");
  }
  count(kFrames);
  return size_t(p - src);
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected 0x82F63B78), slicing by 8

uint32_t g_crc[8][256];

struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      g_crc[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t) g_crc[t][i] = (g_crc[t - 1][i] >> 8) ^ g_crc[0][g_crc[t - 1][i] & 0xFF];
  }
} g_crc_init;

}  // namespace

extern "C" {

// Decodes every frame in src[0:n) into dst (capacity `cap`); returns the
// bytes written, or -1 with zd_last_error() set.
long long zd_decompress(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  try {
    if (n < 0 || cap < 0) fail("negative size");
    Output o{dst, size_t(cap), 0, 0};
    size_t at = 0, len = size_t(n);
    if (len == 0) fail("no frame");
    while (at < len) {
      if (len - at < 4) fail("truncated frame magic");
      uint32_t magic = rd32(src + at);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (len - at < 8) fail("truncated skippable frame");
        size_t size = rd32(src + at + 4);
        if (size > len - at - 8) fail("truncated skippable frame");
        count(kSkippableFrames);
        at += 8 + size;
        continue;
      }
      if (magic != 0xFD2FB528u) fail("not a zstd frame (magic " + std::to_string(magic) + ")");
      at += decode_frame(src + at, len - at, o);
    }
    return (long long)o.pos;
  } catch (const Error& e) {
    g_error = e.what;
    return -1;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// The content size the first frame's header declares, or -1 when it has
// none (-2: not a zstd frame).
long long zd_content_size(const uint8_t* src, long long n) {
  if (n < 6 || rd32(src) != 0xFD2FB528u) return -2;
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  static const int did_size[4] = {0, 1, 2, 4};
  size_t at = 5 + (single ? 0 : 1) + size_t(did_size[fhd & 3]);
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (fcs_size == 0) return -1;
  if (at + size_t(fcs_size) > size_t(n)) return -2;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[at + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  return (long long)fcs;
}

const char* zd_last_error() { return g_error.c_str(); }

int zd_counter_count() { return kCounterCount; }

void zd_counters(long long* out) {
  for (int i = 0; i < kCounterCount; ++i) out[i] = g_counts[i].load(std::memory_order_relaxed);
}

void zd_reset_counters() {
  for (int i = 0; i < kCounterCount; ++i) g_counts[i].store(0, std::memory_order_relaxed);
}

unsigned int zd_crc32c(const uint8_t* p, long long n, unsigned int crc) {
  uint32_t c = ~crc;
  size_t len = size_t(n);
  while (len >= 8) {
    uint64_t w = rd64(p) ^ c;
    c = g_crc[7][w & 0xFF] ^ g_crc[6][(w >> 8) & 0xFF] ^ g_crc[5][(w >> 16) & 0xFF] ^ g_crc[4][(w >> 24) & 0xFF] ^
        g_crc[3][(w >> 32) & 0xFF] ^ g_crc[2][(w >> 40) & 0xFF] ^ g_crc[1][(w >> 48) & 0xFF] ^ g_crc[0][w >> 56];
    p += 8;
    len -= 8;
  }
  while (len--) c = (c >> 8) ^ g_crc[0][(c ^ *p++) & 0xFF];
  return ~c;
}

}  // extern "C"
