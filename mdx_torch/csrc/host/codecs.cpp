// Host-side entropy loops of the port's lossless JPEG and JPEG 2000 codecs
// (mdx_torch/io/jpegll.py, mdx_torch/io/jpegls.py, mdx_torch/io/jpeg2k.py).
//
// The JAX package's native/mdxio.cpp holds the same six loops; this is the
// port's own copy of them, with the same C ABI under the mdx_torch_io_
// prefix, the same return codes and the same control flow, so that a stream
// decodes and encodes bit for bit as there.  The loops are serial (one
// entropy-coded segment or one JPEG 2000 code-block per call) and
// integer-only; mdx_torch/io/native.py builds this file with the host C++
// compiler at first use and calls it through ctypes, which releases the GIL
// for the call, so frames (and JPEG 2000 code-blocks) decode in parallel on
// the reader's thread pools.
//
// Exposed C ABI:
//   mdx_torch_io_jpegll_diffs   : JPEG Lossless entropy decode (T.81 H/F.2)
//   mdx_torch_io_jpegll_pack    : JPEG Lossless entropy encode bit packer
//   mdx_torch_io_jpegls_decode  : JPEG-LS scan decode (T.87 clause A)
//   mdx_torch_io_jpegls_encode  : JPEG-LS scan encode (T.87 clause A)
//   mdx_torch_io_jpeg2k_t1      : JPEG 2000 EBCOT Tier-1 code-block decode
//   mdx_torch_io_jpeg2k_t1_enc  : JPEG 2000 EBCOT Tier-1 code-block encode
//                                 (ISO/IEC 15444-1 Annexes C and D)
//
// Build: c++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off (no OpenMP, no
// -march=native, no PyTorch headers).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG Lossless (ITU-T T.81 process 14) entropy decode: destuffed scan
// bytes → per-sample signed differences (Huffman per F.2.2.3 + DC
// magnitude-category extend, with SSSS=16 meaning +32768 and no extra
// bits).  Prediction/undifferencing stays on the NumPy side.  Identical
// control flow and error taxonomy to _scan_diffs_py: returns `count` on
// success, -1 truncated input, -2 invalid code/symbol, -3 table mismatch.
// ---------------------------------------------------------------------------

int64_t mdx_torch_io_jpegll_diffs(const uint8_t *seg, int64_t n,
                                  const uint8_t *counts /* 16 */,
                                  const uint8_t *values, int64_t n_values,
                                  int64_t count, int32_t *out) {
  int32_t mincode[17], maxcode[17], valptr[17];
  int code = 0, k = 0;
  for (int L = 1; L <= 16; ++L) {
    const int c = counts[L - 1];
    maxcode[L] = -1;
    valptr[L] = 0;
    mincode[L] = 0;
    if (c) {
      valptr[L] = k;
      mincode[L] = code;
      code += c;
      maxcode[L] = code - 1;
      k += c;
    }
    code <<= 1;
  }
  if (k != n_values) return -3;
  int64_t i = 0;  // byte cursor; bitpos counts consumed MSB-first bits
  int bitpos = 0;
  for (int64_t m = 0; m < count; ++m) {
    int c = 0, L = 0;
    for (;;) {
      if (i >= n) return -1;
      const int bit = (seg[i] >> (7 - bitpos)) & 1;
      if (++bitpos == 8) {
        bitpos = 0;
        ++i;
      }
      c = (c << 1) | bit;
      if (++L > 16) return -2;
      if (maxcode[L] >= c) break;
    }
    const int s = values[valptr[L] + c - mincode[L]];
    int32_t d;
    if (s == 0) {
      d = 0;
    } else if (s == 16) {
      d = 32768;
    } else if (s > 16) {
      return -2;
    } else {
      int v = 0;
      for (int b = 0; b < s; ++b) {
        if (i >= n) return -1;
        v = (v << 1) | ((seg[i] >> (7 - bitpos)) & 1);
        if (++bitpos == 8) {
          bitpos = 0;
          ++i;
        }
      }
      d = (v >= (1 << (s - 1))) ? v : v - (1 << s) + 1;
    }
    out[m] = d;
  }
  return count;
}

// ---------------------------------------------------------------------------
// JPEG Lossless entropy ENCODE bit packer: per-sample (Huffman code, extra
// bits) → MSB-first bit stream, 1-padded to a byte, 0xFF byte-stuffed
// inline.  Bit-identical to the NumPy packer _pack_segment_py.  `ssss` are
// the per-sample categories (0..16), `evals` the pre-adjusted extra-bit
// values; `code_of`/`len_of` index by category.  `out` needs capacity >=
// count*8 + 2 (<=32 bits per sample, doubled by worst-case stuffing).
// Returns bytes written.
// ---------------------------------------------------------------------------

int64_t mdx_torch_io_jpegll_pack(const uint8_t *ssss, const int64_t *evals,
                                 int64_t count, const int64_t *code_of,
                                 const int64_t *len_of, uint8_t *out) {
  int64_t o = 0;
  uint64_t acc = 0;  // low `nacc` bits are the pending bit stream tail
  int nacc = 0;
  for (int64_t m = 0; m < count; ++m) {
    const int s = ssss[m];
    const int eb = (s == 0 || s == 16) ? 0 : s;
    const int nb = static_cast<int>(len_of[s]) + eb;
    acc = (acc << nb) |
          ((static_cast<uint64_t>(code_of[s]) << eb) |
           static_cast<uint64_t>(evals[m]));
    nacc += nb;
    while (nacc >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (nacc - 8));
      out[o++] = b;
      if (b == 0xFF) out[o++] = 0x00;
      nacc -= 8;
      acc &= (uint64_t(1) << nacc) - 1;
    }
  }
  if (nacc) {
    const uint8_t b = static_cast<uint8_t>(
        (acc << (8 - nacc)) | ((uint64_t(1) << (8 - nacc)) - 1));
    out[o++] = b;
    if (b == 0xFF) out[o++] = 0x00;
  }
  return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG-LS (ITU-T T.87) scan codec.  LOCO-I is adaptive in BOTH directions
// (every sample updates the contexts coding the next), so neither side
// vectorises; decode AND encode run here, bit-identical to the Python coder
// of mdx_torch/io/jpegls.py with the same error taxonomy: -1 truncated
// input, -2 corrupt Golomb code, -3 run length exceeds the line, -4 entropy
// segment ends at a marker mid-symbol, -5 output capacity exceeded (encode
// only).  Control flow mirrors _ScanCoder there exactly; the clause-A
// citations live there.
// ---------------------------------------------------------------------------

namespace jls {

struct Err {
  int64_t code;
};

static const int32_t kJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
                               7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Params {
  int32_t maxval, near, t1, t2, t3, reset;
  int64_t range;
  int32_t limit, qbpp, a_init, t;  // t = 2*near + 1
};

struct Coder {
  const Params &p;
  std::vector<int64_t> A, B, C, N;
  int64_t Nn[2];
  int32_t run_index;

  explicit Coder(const Params &pp)
      : p(pp), A(367, pp.a_init), B(365, 0), C(365, 0), N(367, 1),
        run_index(0) {
    Nn[0] = Nn[1] = 0;
  }

  inline int32_t quantize(int32_t d) const {
    if (d <= -p.t3) return -4;
    if (d <= -p.t2) return -3;
    if (d <= -p.t1) return -2;
    if (d < -p.near) return -1;
    if (d <= p.near) return 0;
    if (d < p.t1) return 1;
    if (d < p.t2) return 2;
    if (d < p.t3) return 3;
    return 4;
  }

  inline void context(int32_t ra, int32_t rb, int32_t rc, int32_t rd,
                      int32_t *q, int32_t *sign) const {
    int32_t q1 = quantize(rd - rb), q2 = quantize(rb - rc),
            q3 = quantize(rc - ra);
    if (q1 < 0 || (q1 == 0 && (q2 < 0 || (q2 == 0 && q3 < 0)))) {
      *q = 81 * -q1 + 9 * -q2 + -q3;
      *sign = -1;
    } else {
      *q = 81 * q1 + 9 * q2 + q3;
      *sign = 1;
    }
  }

  inline int32_t corrected_prediction(int32_t q, int32_t sign, int32_t ra,
                                      int32_t rb, int32_t rc) const {
    int32_t px;
    const int32_t mx = std::max(ra, rb), mn = std::min(ra, rb);
    if (rc >= mx)
      px = mn;
    else if (rc <= mn)
      px = mx;
    else
      px = ra + rb - rc;
    px += sign * static_cast<int32_t>(C[q]);
    if (px < 0) return 0;
    if (px > p.maxval) return p.maxval;
    return px;
  }

  inline int32_t golomb_k(int32_t q) const {
    int32_t k = 0;
    while ((N[q] << k) < A[q]) ++k;
    return k;
  }

  inline int64_t mod_range(int64_t e) const {
    if (e < 0) e += p.range;
    if (e >= (p.range + 1) / 2) e -= p.range;
    return e;
  }

  inline int64_t quant_err(int64_t e) const {
    if (p.near == 0) return e;
    if (e > 0) return (p.near + e) / p.t;
    return -((p.near - e) / p.t);
  }

  inline void update_regular(int32_t q, int64_t e) {
    B[q] += e * p.t;
    A[q] += (e < 0) ? -e : e;
    if (N[q] == p.reset) {
      A[q] >>= 1;
      B[q] >>= 1;  // arithmetic shift: floor, matching Python >>
      N[q] >>= 1;
    }
    N[q] += 1;
    if (B[q] <= -N[q]) {
      B[q] += N[q];
      if (C[q] > -128) C[q] -= 1;
      if (B[q] <= -N[q]) B[q] = -N[q] + 1;
    } else if (B[q] > 0) {
      B[q] -= N[q];
      if (C[q] < 127) C[q] += 1;
      if (B[q] > 0) B[q] = 0;
    }
  }

  inline int32_t ri_k(int32_t ritype) const {
    const int32_t q = 365 + ritype;
    const int64_t temp = ritype ? A[q] + (N[q] >> 1) : A[q];
    int32_t k = 0;
    while ((N[q] << k) < temp) ++k;
    return k;
  }

  inline void ri_update(int32_t ritype, int64_t e, int64_t em) {
    const int32_t q = 365 + ritype;
    if (e < 0) Nn[ritype] += 1;
    A[q] += (em + 1 - ritype) >> 1;
    if (N[q] == p.reset) {
      A[q] >>= 1;
      N[q] >>= 1;
      Nn[ritype] >>= 1;
    }
    N[q] += 1;
  }
};

// -- bit reader (clause-C stuffing: a byte after 0xFF carries 7 bits) ------

struct BitReader {
  const uint8_t *buf;
  int64_t n, pos;
  uint64_t cache;
  int32_t nbits;
  bool prev_ff;

  BitReader(const uint8_t *b, int64_t nn, int64_t p)
      : buf(b), n(nn), pos(p), cache(0), nbits(0), prev_ff(false) {}

  inline void fill() {
    if (pos >= n) throw Err{-1};
    const uint8_t b = buf[pos];
    if (prev_ff) {
      if (b & 0x80) throw Err{-4};
      ++pos;
      cache = (cache << 7) | b;
      nbits += 7;
      prev_ff = false;
    } else {
      ++pos;
      cache = (cache << 8) | b;
      nbits += 8;
      prev_ff = (b == 0xFF);
    }
  }

  inline int32_t read_bit() {
    if (nbits == 0) fill();
    --nbits;
    return static_cast<int32_t>((cache >> nbits) & 1);
  }

  inline int64_t read_bits(int32_t k) {
    while (nbits < k) fill();
    nbits -= k;
    return static_cast<int64_t>((cache >> nbits) &
                                ((uint64_t(1) << k) - 1));
  }

  int64_t align_to_marker() {
    int64_t p = pos;
    if (prev_ff) --p;  // the 0xFF already pulled into the cache
    return p;
  }
};

struct BitWriter {
  uint8_t *out;
  int64_t cap, o;
  uint32_t cur;
  int32_t free_, width;  // width = current byte capacity (7 after 0xFF)

  BitWriter(uint8_t *buf, int64_t capacity)
      : out(buf), cap(capacity), o(0), cur(0), free_(8), width(8) {}

  inline void write_bits(uint64_t value, int32_t nb) {
    while (nb > 0) {
      const int32_t take = std::min(nb, free_);
      nb -= take;
      free_ -= take;
      cur |= static_cast<uint32_t>((value >> nb) &
                                   ((uint64_t(1) << take) - 1))
             << free_;
      if (free_ == 0) {
        if (o >= cap) throw Err{-5};
        out[o++] = static_cast<uint8_t>(cur);
        width = free_ = (cur == 0xFF) ? 7 : 8;
        cur = 0;
      }
    }
  }

  inline void write_unary(int64_t zeros) {
    while (zeros >= 24) {
      write_bits(0, 24);
      zeros -= 24;
    }
    write_bits(1, static_cast<int32_t>(zeros) + 1);
  }

  void flush() {
    if (free_ != width) {
      if (o >= cap) throw Err{-5};
      out[o++] = static_cast<uint8_t>(cur);
    }
    cur = 0;
    width = free_ = 8;
  }
};

// -- limited-length Golomb (A.5.3) -----------------------------------------

static inline int64_t read_lg(BitReader &br, const Params &p, int32_t k,
                              int32_t limit) {
  const int32_t zmax = limit - p.qbpp - 1;
  int32_t z = 0;
  while (br.read_bit() == 0) {
    if (++z > zmax) throw Err{-2};
  }
  if (z < zmax) return (static_cast<int64_t>(z) << k) |
                       (k ? br.read_bits(k) : 0);
  return br.read_bits(p.qbpp) + 1;
}

static inline void write_lg(BitWriter &bw, const Params &p, int64_t merr,
                            int32_t k, int32_t limit) {
  const int32_t zmax = limit - p.qbpp - 1;
  const int64_t hi = merr >> k;
  if (hi < zmax) {
    bw.write_unary(hi);
    if (k) bw.write_bits(merr & ((uint64_t(1) << k) - 1), k);
  } else {
    bw.write_unary(zmax);
    bw.write_bits(static_cast<uint64_t>(merr - 1), p.qbpp);
  }
}

// -- regular mode ----------------------------------------------------------

static inline int32_t decode_regular(Coder &cd, BitReader &br, int32_t q,
                                     int32_t sign, int32_t px) {
  const Params &p = cd.p;
  const int32_t k = cd.golomb_k(q);
  const int64_t merr = read_lg(br, p, k, p.limit);
  int64_t e;
  if (p.near == 0 && k == 0 && 2 * cd.B[q] <= -cd.N[q]) {
    e = (merr & 1) ? (merr - 1) / 2 : -(merr / 2) - 1;
  } else {
    e = (merr & 1) ? -((merr + 1) / 2) : merr / 2;
  }
  cd.update_regular(q, e);
  int64_t rx = px + static_cast<int64_t>(sign) * e * p.t;
  if (rx < -p.near)
    rx += p.range * p.t;
  else if (rx > p.maxval + p.near)
    rx -= p.range * p.t;
  if (rx < 0)
    rx = 0;
  else if (rx > p.maxval)
    rx = p.maxval;
  return static_cast<int32_t>(rx);
}

static inline int32_t encode_regular(Coder &cd, BitWriter &bw, int32_t q,
                                     int32_t sign, int32_t px, int32_t x) {
  const Params &p = cd.p;
  int64_t e = x - px;
  if (sign < 0) e = -e;
  e = cd.quant_err(e);
  int64_t rx = px + static_cast<int64_t>(sign) * e * p.t;
  if (rx < 0)
    rx = 0;
  else if (rx > p.maxval)
    rx = p.maxval;
  e = cd.mod_range(e);
  const int32_t k = cd.golomb_k(q);
  int64_t merr;
  if (p.near == 0 && k == 0 && 2 * cd.B[q] <= -cd.N[q]) {
    merr = (e >= 0) ? 2 * e + 1 : -2 * (e + 1);
  } else {
    merr = (e >= 0) ? 2 * e : -2 * e - 1;
  }
  write_lg(bw, p, merr, k, p.limit);
  cd.update_regular(q, e);
  return static_cast<int32_t>(rx);
}

// -- run interruption (A.7.1.5/A.7.2) --------------------------------------

static inline int32_t decode_run_interruption(Coder &cd, BitReader &br,
                                              int32_t ra, int32_t rb) {
  const Params &p = cd.p;
  const int32_t ritype = (std::abs(ra - rb) <= p.near) ? 1 : 0;
  const int32_t px = ritype ? ra : rb;
  const int32_t sign = (ritype == 0 && ra > rb) ? -1 : 1;
  const int32_t k = cd.ri_k(ritype);
  const int64_t em = read_lg(br, p, k, p.limit - kJ[cd.run_index] - 1);
  const int64_t temp = em + ritype;
  const int32_t map_bit = static_cast<int32_t>(temp & 1);
  const int64_t e_abs = (temp + map_bit) / 2;
  const int32_t q365 = 365 + ritype;
  int64_t e;
  if ((k != 0 || (2 * cd.Nn[ritype] >= cd.N[q365])) == (map_bit != 0))
    e = -e_abs;
  else
    e = e_abs;
  cd.ri_update(ritype, e, em);
  int64_t rx = px + static_cast<int64_t>(sign) * e * p.t;
  if (rx < -p.near)
    rx += p.range * p.t;
  else if (rx > p.maxval + p.near)
    rx -= p.range * p.t;
  if (rx < 0)
    rx = 0;
  else if (rx > p.maxval)
    rx = p.maxval;
  return static_cast<int32_t>(rx);
}

static inline int32_t encode_run_interruption(Coder &cd, BitWriter &bw,
                                              int32_t ra, int32_t rb,
                                              int32_t x) {
  const Params &p = cd.p;
  const int32_t ritype = (std::abs(ra - rb) <= p.near) ? 1 : 0;
  const int32_t px = ritype ? ra : rb;
  const int32_t sign = (ritype == 0 && ra > rb) ? -1 : 1;
  int64_t e = x - px;
  if (sign < 0) e = -e;
  e = cd.quant_err(e);
  int64_t rx = px + static_cast<int64_t>(sign) * e * p.t;
  if (rx < 0)
    rx = 0;
  else if (rx > p.maxval)
    rx = p.maxval;
  e = cd.mod_range(e);
  const int32_t k = cd.ri_k(ritype);
  const int32_t q365 = 365 + ritype;
  int32_t map_bit;
  if (k == 0 && e > 0 && 2 * cd.Nn[ritype] < cd.N[q365])
    map_bit = 1;
  else if (e < 0 && 2 * cd.Nn[ritype] >= cd.N[q365])
    map_bit = 1;
  else if (e < 0 && k != 0)
    map_bit = 1;
  else
    map_bit = 0;
  const int64_t em = 2 * ((e < 0) ? -e : e) - ritype - map_bit;
  write_lg(bw, p, em, k, p.limit - kJ[cd.run_index] - 1);
  cd.ri_update(ritype, e, em);
  return static_cast<int32_t>(rx);
}

}  // namespace jls

extern "C" {

// Decode one entropy segment of `height` lines.  `out` gets
// height*width int32 samples; *end_pos gets the offset of the
// terminating marker (or segment end).  Returns 0 or a jls error code.
int64_t mdx_torch_io_jpegls_decode(const uint8_t *buf, int64_t n,
                                   int64_t pos, int32_t width,
                                   int32_t height, int32_t maxval,
                                   int32_t near, int32_t t1, int32_t t2,
                                   int32_t t3, int32_t reset, int64_t range,
                                   int32_t limit, int32_t qbpp,
                                   int32_t a_init, int32_t *out,
                                   int64_t *end_pos) {
  const jls::Params p{maxval, near,  t1,   t2,     t3, reset,
                      range,  limit, qbpp, a_init, 2 * near + 1};
  jls::Coder cd(p);
  jls::BitReader br(buf, n, pos);
  std::vector<int32_t> prev(width, 0);
  int32_t edge = 0;
  try {
    for (int32_t row = 0; row < height; ++row) {
      int32_t *cur = out + static_cast<int64_t>(row) * width;
      const int32_t ra0 = prev[0];
      int32_t col = 0;
      while (col < width) {
        const int32_t ra = col > 0 ? cur[col - 1] : ra0;
        const int32_t rb = prev[col];
        const int32_t rc = col > 0 ? prev[col - 1] : edge;
        const int32_t rd = col + 1 < width ? prev[col + 1] : prev[width - 1];
        int32_t q, sign;
        cd.context(ra, rb, rc, rd, &q, &sign);
        if (q == 0) {
          // run mode: every run sample reconstructs to ra
          for (;;) {
            if (br.read_bit() == 1) {
              const int32_t seg = 1 << jls::kJ[cd.run_index];
              const int32_t fill = std::min(seg, width - col);
              for (int32_t i = 0; i < fill; ++i) cur[col + i] = ra;
              col += fill;
              if (fill < seg) break;      // partial segment: end of line
              if (cd.run_index < 31) cd.run_index += 1;
              if (col == width) break;    // exact segment to line end
            } else {
              const int32_t nb = jls::kJ[cd.run_index];
              const int64_t cnt = nb ? br.read_bits(nb) : 0;
              if (cnt > width - col - 1) throw jls::Err{-3};
              for (int64_t i = 0; i < cnt; ++i) cur[col + i] = ra;
              col += static_cast<int32_t>(cnt);
              cur[col] = jls::decode_run_interruption(cd, br, ra, prev[col]);
              col += 1;
              if (cd.run_index > 0) cd.run_index -= 1;
              break;
            }
          }
        } else {
          const int32_t px = cd.corrected_prediction(q, sign, ra, rb, rc);
          cur[col] = jls::decode_regular(cd, br, q, sign, px);
          col += 1;
        }
      }
      edge = ra0;
      std::copy(cur, cur + width, prev.begin());
    }
  } catch (const jls::Err &e) {
    return e.code;
  }
  *end_pos = br.align_to_marker();
  return 0;
}

// Encode one component plane; returns bytes written or a jls error code.
int64_t mdx_torch_io_jpegls_encode(const int32_t *img, int32_t width,
                                   int32_t height, int32_t maxval,
                                   int32_t near, int32_t t1, int32_t t2,
                                   int32_t t3, int32_t reset, int64_t range,
                                   int32_t limit, int32_t qbpp,
                                   int32_t a_init, uint8_t *out,
                                   int64_t cap) {
  const jls::Params p{maxval, near,  t1,   t2,     t3, reset,
                      range,  limit, qbpp, a_init, 2 * near + 1};
  jls::Coder cd(p);
  jls::BitWriter bw(out, cap);
  std::vector<int32_t> prev(width, 0), recon(width, 0);
  int32_t edge = 0;
  try {
    for (int32_t row = 0; row < height; ++row) {
      const int32_t *line = img + static_cast<int64_t>(row) * width;
      const int32_t ra0 = prev[0];
      int32_t col = 0;
      while (col < width) {
        const int32_t ra = col > 0 ? recon[col - 1] : ra0;
        const int32_t rb = prev[col];
        const int32_t rc = col > 0 ? prev[col - 1] : edge;
        const int32_t rd = col + 1 < width ? prev[col + 1] : prev[width - 1];
        int32_t q, sign;
        cd.context(ra, rb, rc, rd, &q, &sign);
        if (q == 0) {
          int64_t cnt = 0;
          while (col < width && std::abs(line[col] - ra) <= p.near) {
            recon[col] = ra;
            ++col;
            ++cnt;
          }
          while (cnt >= (int64_t(1) << jls::kJ[cd.run_index])) {
            bw.write_bits(1, 1);
            cnt -= int64_t(1) << jls::kJ[cd.run_index];
            if (cd.run_index < 31) cd.run_index += 1;
          }
          if (col == width) {
            if (cnt > 0) bw.write_bits(1, 1);
          } else {
            bw.write_bits(0, 1);
            const int32_t nb = jls::kJ[cd.run_index];
            if (nb) bw.write_bits(static_cast<uint64_t>(cnt), nb);
            recon[col] = jls::encode_run_interruption(cd, bw, ra, prev[col],
                                                      line[col]);
            col += 1;
            if (cd.run_index > 0) cd.run_index -= 1;
          }
        } else {
          const int32_t px = cd.corrected_prediction(q, sign, ra, rb, rc);
          recon[col] = jls::encode_regular(cd, bw, q, sign, px, line[col]);
          col += 1;
        }
      }
      edge = ra0;
      std::swap(prev, recon);  // recon is fully rewritten next line
    }
    bw.flush();
  } catch (const jls::Err &e) {
    return e.code;
  }
  return bw.o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG 2000 EBCOT Tier-1 (ISO 15444-1 Annex D) — the serial hot loop of
// mdx_torch/io/jpeg2k.py.  The MQ coder and the three coding passes are
// adaptive bit-serial state machines (every decoded decision updates the
// context states coding the next), so nothing vectorises; one call
// decodes ALL of one code-block's passes, bit-identical to the Python
// oracle (_t1_decode_block) including the in-loop half-LSB
// reconstruction.  Error taxonomy: -1 segmentation-symbol mismatch
// (the only data-detectable corruption — both bit readers legally feed
// 1-bits past the end of a segment, Annex C).
// ---------------------------------------------------------------------------

namespace j2k {

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

static const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxRl = 17;
constexpr int kCtxUni = 18;
constexpr int kNCtx = 19;

struct Ctx {
  uint8_t idx[kNCtx];
  uint8_t mps[kNCtx];
  void reset() {
    for (int i = 0; i < kNCtx; ++i) {
      idx[i] = 0;
      mps[i] = 0;
    }
    idx[0] = 4;
    idx[kCtxRl] = 3;
    idx[kCtxUni] = 46;
  }
};

struct Mq {
  const uint8_t *d;
  int64_t len, bp;
  uint32_t c, a;
  int32_t ct;

  void bytein() {
    const uint32_t b = (bp < len) ? d[bp] : 0xFF;
    if (b == 0xFF) {
      const uint32_t b1 = (bp + 1 < len) ? d[bp + 1] : 0xFF;
      if (b1 > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += b1 << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      const uint32_t b1 = (bp < len) ? d[bp] : 0xFF;
      c += b1 << 8;
      ct = 8;
    }
  }

  void init(const uint8_t *data, int64_t n) {
    d = data;
    len = n;
    bp = 0;
    const uint32_t b0 = n ? d[0] : 0xFF;
    c = b0 << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(Ctx &cx, int ci) {
    const MqState &st = kMq[cx.idx[ci]];
    const uint32_t qe = st.qe;
    int d_;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d_ = cx.mps[ci];
        cx.idx[ci] = st.nmps;
      } else {
        d_ = 1 - cx.mps[ci];
        if (st.sw) cx.mps[ci] = 1 - cx.mps[ci];
        cx.idx[ci] = st.nlps;
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return cx.mps[ci];
      if (a < qe) {
        d_ = 1 - cx.mps[ci];
        if (st.sw) cx.mps[ci] = 1 - cx.mps[ci];
        cx.idx[ci] = st.nlps;
      } else {
        d_ = cx.mps[ci];
        cx.idx[ci] = st.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return d_;
  }
};

struct Raw {
  const uint8_t *d;
  int64_t len, pos;
  uint32_t buf;
  int32_t cnt;
  uint32_t last;

  void init(const uint8_t *data, int64_t n) {
    d = data;
    len = n;
    pos = 0;
    buf = 0;
    cnt = 0;
    last = 0;
  }

  int bit() {
    if (cnt == 0) {
      const bool prev_ff = last == 0xFF;
      buf = (pos < len) ? d[pos++] : 0xFF;
      last = buf;
      cnt = prev_ff ? 7 : 8;
    }
    --cnt;
    return (buf >> cnt) & 1;
  }
};

// significance context tables [h][v][d] per Table D.1 (same formulas as
// the Python _sig_ctx_tables)
struct SigTabs {
  int8_t ll[3][3][5], hl[3][3][5], hh[3][3][5];
  SigTabs() {
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) {
          int c;
          if (h == 2)
            c = 8;
          else if (h == 1)
            c = (v >= 1) ? 7 : (d >= 1 ? 6 : 5);
          else if (v == 2)
            c = 4;
          else if (v == 1)
            c = 3;
          else if (d >= 2)
            c = 2;
          else
            c = d;
          ll[h][v][d] = static_cast<int8_t>(c);
          hl[v][h][d] = static_cast<int8_t>(c);  // H/V swapped
          int hv = h + v > 2 ? 2 : h + v;
          int ch;
          if (d >= 3)
            ch = 8;
          else if (d == 2)
            ch = hv >= 1 ? 7 : 6;
          else if (d == 1)
            ch = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
          else
            ch = hv >= 2 ? 2 : hv;
          hh[h][v][d] = static_cast<int8_t>(ch);
        }
  }
};
static const SigTabs kSig;

// sign-coding (ctx, xor) by (hc+1, vc+1) — Table D.3/D.4
static const int8_t kSignCtx[3][3] = {{13, 12, 11}, {10, 9, 10},
                                      {11, 12, 13}};
static const int8_t kSignXor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
// rows indexed by hc+1, cols by vc+1:
//   hc=-1: vc -1/0/1 -> (13,1) (12,1) (11,1)
//   hc= 0: vc -1/0/1 -> (10,1) ( 9,0) (10,0)
//   hc= 1: vc -1/0/1 -> (11,0) (12,0) (13,0)

struct T1 {
  int32_t w, h, btype;
  bool vsc;
  std::vector<uint8_t> sig;    // (h+2)*(w+2) apron
  std::vector<uint8_t> vis, refined;
  int32_t *data;               // h*w, caller-owned
  Ctx cx;
  Mq mq;
  Raw raw;
  bool mq_live = false;

  T1(int32_t w_, int32_t h_, int32_t bt, bool vsc_, int32_t *out)
      : w(w_), h(h_), btype(bt), vsc(vsc_),
        sig((h_ + 2) * (w_ + 2), 0), vis(h_ * w_, 0),
        refined(h_ * w_, 0), data(out) {
    cx.reset();
  }

  inline uint8_t s_at(int x, int y) const {  // apron coords offset +1
    return sig[(y + 1) * (w + 2) + (x + 1)];
  }
  inline void s_set(int x, int y) { sig[(y + 1) * (w + 2) + (x + 1)] = 1; }

  inline void neigh(int x, int y, int *hc, int *vc, int *dc) const {
    const int d_ok = (vsc && (y % 4) == 3) ? 0 : 1;
    *hc = s_at(x - 1, y) + s_at(x + 1, y);
    *vc = s_at(x, y - 1) + s_at(x, y + 1) * d_ok;
    *dc = s_at(x - 1, y - 1) + s_at(x + 1, y - 1) +
          (s_at(x - 1, y + 1) + s_at(x + 1, y + 1)) * d_ok;
  }

  inline int sig_ctx(int hc, int vc, int dc) const {
    if (hc > 2) hc = 2;
    if (vc > 2) vc = 2;
    if (dc > 4) dc = 4;
    if (btype == 1) return kSig.hl[hc][vc][dc];
    if (btype == 3) return kSig.hh[hc][vc][dc];
    return kSig.ll[hc][vc][dc];
  }

  inline void sign_ctx(int x, int y, int *ci, int *xr) const {
    const int d_ok = (vsc && (y % 4) == 3) ? 0 : 1;
    int hc = 0, vc = 0;
    if (s_at(x - 1, y)) hc += (x > 0 && data[y * w + x - 1] < 0) ? -1 : 1;
    if (s_at(x + 1, y)) hc += (x < w - 1 && data[y * w + x + 1] < 0) ? -1 : 1;
    if (hc < -1) hc = -1;
    if (hc > 1) hc = 1;
    if (s_at(x, y - 1)) vc += (y > 0 && data[(y - 1) * w + x] < 0) ? -1 : 1;
    if (s_at(x, y + 1) && d_ok)
      vc += (y < h - 1 && data[(y + 1) * w + x] < 0) ? -1 : 1;
    if (vc < -1) vc = -1;
    if (vc > 1) vc = 1;
    *ci = kSignCtx[hc + 1][vc + 1];
    *xr = kSignXor[hc + 1][vc + 1];
  }

  inline void set_sig(int x, int y, int neg, int bp) {
    const int32_t one = 1 << bp;
    const int32_t val = one | (one >> 1);
    data[y * w + x] = neg ? -val : val;
    s_set(x, y);
  }

  void pass_sig(int bp, bool rawpass) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        for (int y = y0; y < ylim; ++y) {
          if (s_at(x, y)) continue;
          int hc, vc, dc;
          neigh(x, y, &hc, &vc, &dc);
          if (hc + vc + dc == 0) continue;
          int bit;
          if (rawpass)
            bit = raw.bit();
          else
            bit = mq.decode(cx, sig_ctx(hc, vc, dc));
          if (bit) {
            int s;
            if (rawpass) {
              s = raw.bit();
            } else {
              int ci, xr;
              sign_ctx(x, y, &ci, &xr);
              s = mq.decode(cx, ci) ^ xr;
            }
            set_sig(x, y, s, bp);
          }
          vis[y * w + x] = 1;
        }
      }
  }

  void pass_ref(int bp, bool rawpass) {
    const int32_t one = 1 << bp;
    const int32_t poshalf = one >> 1;
    const int32_t neghalf = poshalf ? poshalf : 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        for (int y = y0; y < ylim; ++y) {
          const int i = y * w + x;
          if (!s_at(x, y) || vis[i]) continue;
          int bit;
          if (rawpass) {
            bit = raw.bit();
          } else {
            int ci;
            if (refined[i]) {
              ci = 16;
            } else {
              int hc, vc, dc;
              neigh(x, y, &hc, &vc, &dc);
              ci = (hc + vc + dc) ? 15 : 14;
            }
            bit = mq.decode(cx, ci);
          }
          const int32_t delta = bit ? poshalf : -neghalf;
          if (data[i] < 0)
            data[i] -= delta;
          else
            data[i] += delta;
          refined[i] = 1;
          vis[i] = 1;
        }
      }
  }

  void pass_cleanup(int bp) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        while (y < ylim) {
          if (y == y0 && y0 + 4 <= h) {
            bool ok = true;
            for (int yy = y0; yy < y0 + 4; ++yy) {
              if (s_at(x, yy) || vis[yy * w + x]) {
                ok = false;
                break;
              }
              int hc, vc, dc;
              neigh(x, yy, &hc, &vc, &dc);
              if (hc + vc + dc) {
                ok = false;
                break;
              }
            }
            if (ok) {
              if (!mq.decode(cx, kCtxRl)) {
                y = y0 + 4;
                continue;
              }
              const int pos =
                  (mq.decode(cx, kCtxUni) << 1) | mq.decode(cx, kCtxUni);
              y = y0 + pos;
              int ci, xr;
              sign_ctx(x, y, &ci, &xr);
              const int s = mq.decode(cx, ci) ^ xr;
              set_sig(x, y, s, bp);
              ++y;
              continue;
            }
          }
          if (s_at(x, y) || vis[y * w + x]) {
            ++y;
            continue;
          }
          int hc, vc, dc;
          neigh(x, y, &hc, &vc, &dc);
          if (mq.decode(cx, sig_ctx(hc, vc, dc))) {
            int ci, xr;
            sign_ctx(x, y, &ci, &xr);
            const int s = mq.decode(cx, ci) ^ xr;
            set_sig(x, y, s, bp);
          }
          ++y;
        }
      }
  }
};

}  // namespace j2k

extern "C" {

// Decode one code-block's coding passes.  Segments arrive
// pre-terminated (mdx_torch/io/jpeg2k.py::_codeword_segments): seg_data is
// the concatenation, per-segment (len, first pass, npasses, raw).
// flags = the COD code-block style byte.  out: h*w int32, zeroed by the
// caller.  Returns 0, or -1 on a segmentation-symbol mismatch.
int64_t mdx_torch_io_jpeg2k_t1(const uint8_t *seg_data,
                               const int64_t *seg_lens,
                               const int32_t *seg_first,
                               const int32_t *seg_npasses,
                               const uint8_t *seg_raw, int32_t nsegs,
                               int32_t w, int32_t h, int32_t btype,
                               int32_t numbps, int32_t total, int32_t flags,
                               int32_t *out) {
  const bool vsc = flags & 0x08;
  const bool segsym = flags & 0x20;
  const bool reset = flags & 0x02;
  const bool termall = flags & 0x04;
  const bool lazy = flags & 0x01;
  j2k::T1 t1(w, h, btype, vsc, out);

  int64_t off = 0;
  int32_t p_done = 0;
  for (int32_t si = 0; si < nsegs && p_done < total; ++si) {
    const uint8_t *bytes = seg_data + off;
    const int64_t blen = seg_lens[si];
    off += blen;
    const bool rawseg = seg_raw[si] != 0;
    if (rawseg) {
      t1.raw.init(bytes, blen);
      t1.mq_live = false;
    } else if (!t1.mq_live || termall || lazy) {
      t1.mq.init(bytes, blen);
      t1.mq_live = true;
    }
    const int32_t first = seg_first[si];
    int32_t npasses = seg_npasses[si];
    if (first + npasses > total) npasses = total - first;
    for (int32_t p = first; p < first + npasses; ++p) {
      int kind, bp;
      if (p == 0) {
        kind = 2;
        bp = numbps - 1;
      } else {
        kind = (p - 1) % 3;
        bp = numbps - 2 - (p - 1) / 3;
      }
      if (bp < 0) {
        p_done = total;
        break;
      }
      if (reset && !rawseg) t1.cx.reset();
      if (kind == 0) {
        t1.pass_sig(bp, rawseg);
      } else if (kind == 1) {
        t1.pass_ref(bp, rawseg);
      } else {
        t1.pass_cleanup(bp);
        if (segsym) {
          int s = 0;
          for (int i = 0; i < 4; ++i)
            s = (s << 1) | t1.mq.decode(t1.cx, j2k::kCtxUni);
          if (s != 0x0A) return -1;
        }
        std::fill(t1.vis.begin(), t1.vis.end(), 0);
      }
      ++p_done;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG 2000 EBCOT Tier-1 ENCODER — the serial hot loop of
// mdx_torch/io/jpeg2k.py::_t1_encode_block (the `.4.90` writer).  Mirrors the
// Python coder exactly: same pass traversal, contexts, and Annex C MQ
// encoder (SETBITS flush sets the codeword tail to ones; trailing 0xFF
// dropped) — output bytes are bit-identical to the Python oracle
// (asserted in tests).  Returns the byte length, or -1 if the output
// capacity would overflow (caller sizes generously).
// ---------------------------------------------------------------------------

namespace j2k {

struct MqEnc {
  uint8_t *out;
  int64_t cap, n;
  int64_t b;  // last byte value or -1
  uint32_t a, c;
  int32_t ct;
  bool overflow;

  void init(uint8_t *buf, int64_t capacity) {
    out = buf;
    cap = capacity;
    n = 0;
    b = -1;
    a = 0x8000;
    c = 0;
    ct = 12;
    overflow = false;
  }

  void emit(uint32_t byte) {
    b = byte & 0xFF;
    if (n >= cap) {
      overflow = true;
      return;
    }
    out[n++] = static_cast<uint8_t>(b);
  }

  void byteout() {
    if (b == 0xFF) {
      emit(c >> 20);
      c &= 0xFFFFF;
      ct = 7;
    } else {
      if (c < 0x8000000u) {
        emit(c >> 19);
        c &= 0x7FFFF;
        ct = 8;
      } else {
        b += 1;
        if (n > 0) out[n - 1] = static_cast<uint8_t>(b);
        if (b == 0xFF) {
          c &= 0x7FFFFFF;
          emit(c >> 20);
          c &= 0xFFFFF;
          ct = 7;
        } else {
          emit(c >> 19);
          c &= 0x7FFFF;
          ct = 8;
        }
      }
    }
  }

  void renorm() {
    do {
      if (ct == 0) byteout();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
  }

  void encode(Ctx &cx, int ci, int d) {
    const MqState &st = kMq[cx.idx[ci]];
    const uint32_t qe = st.qe;
    if (d == cx.mps[ci]) {
      a -= qe;
      if (!(a & 0x8000)) {
        if (a < qe)
          a = qe;
        else
          c += qe;
        cx.idx[ci] = st.nmps;
        renorm();
      } else {
        c += qe;
      }
    } else {
      a -= qe;
      if (a < qe)
        c += qe;
      else
        a = qe;
      if (st.sw) cx.mps[ci] = 1 - cx.mps[ci];
      cx.idx[ci] = st.nlps;
      renorm();
    }
  }

  int64_t flush() {
    const uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (n > 0 && out[n - 1] == 0xFF) --n;
    return overflow ? -1 : n;
  }
};

struct T1Enc {
  int32_t w, h, btype;
  std::vector<uint8_t> sig, vis, refined;
  std::vector<int32_t> data;
  const int32_t *mag;
  const uint8_t *neg;
  Ctx cx;
  MqEnc mq;

  T1Enc(int32_t w_, int32_t h_, int32_t bt, const int32_t *mag_,
        const uint8_t *neg_)
      : w(w_), h(h_), btype(bt), sig((h_ + 2) * (w_ + 2), 0),
        vis(h_ * w_, 0), refined(h_ * w_, 0), data(h_ * w_, 0),
        mag(mag_), neg(neg_) {
    cx.reset();
  }

  inline uint8_t s_at(int x, int y) const {
    return sig[(y + 1) * (w + 2) + (x + 1)];
  }
  inline void s_set(int x, int y) { sig[(y + 1) * (w + 2) + (x + 1)] = 1; }

  inline void neigh(int x, int y, int *hc, int *vc, int *dc) const {
    *hc = s_at(x - 1, y) + s_at(x + 1, y);
    *vc = s_at(x, y - 1) + s_at(x, y + 1);
    *dc = s_at(x - 1, y - 1) + s_at(x + 1, y - 1) + s_at(x - 1, y + 1) +
          s_at(x + 1, y + 1);
  }

  inline int sig_ctx(int hc, int vc, int dc) const {
    if (hc > 2) hc = 2;
    if (vc > 2) vc = 2;
    if (dc > 4) dc = 4;
    if (btype == 1) return kSig.hl[hc][vc][dc];
    if (btype == 3) return kSig.hh[hc][vc][dc];
    return kSig.ll[hc][vc][dc];
  }

  inline void sign_ctx(int x, int y, int *ci, int *xr) const {
    int hc = 0, vc = 0;
    if (s_at(x - 1, y)) hc += (x > 0 && data[y * w + x - 1] < 0) ? -1 : 1;
    if (s_at(x + 1, y)) hc += (x < w - 1 && data[y * w + x + 1] < 0) ? -1 : 1;
    if (hc < -1) hc = -1;
    if (hc > 1) hc = 1;
    if (s_at(x, y - 1)) vc += (y > 0 && data[(y - 1) * w + x] < 0) ? -1 : 1;
    if (s_at(x, y + 1)) vc += (y < h - 1 && data[(y + 1) * w + x] < 0) ? -1 : 1;
    if (vc < -1) vc = -1;
    if (vc > 1) vc = 1;
    *ci = kSignCtx[hc + 1][vc + 1];
    *xr = kSignXor[hc + 1][vc + 1];
  }

  inline void set_sig(int x, int y, int bp) {
    const int32_t one = 1 << bp;
    const int32_t val = one | (one >> 1);
    data[y * w + x] = neg[y * w + x] ? -val : val;
    s_set(x, y);
  }

  void pass_sig(int bp) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        for (int y = y0; y < ylim; ++y) {
          if (s_at(x, y)) continue;
          int hc, vc, dc;
          neigh(x, y, &hc, &vc, &dc);
          if (hc + vc + dc == 0) continue;
          const int bit = (mag[y * w + x] >> bp) & 1;
          mq.encode(cx, sig_ctx(hc, vc, dc), bit);
          if (bit) {
            int ci, xr;
            sign_ctx(x, y, &ci, &xr);
            mq.encode(cx, ci, (neg[y * w + x] ? 1 : 0) ^ xr);
            set_sig(x, y, bp);
          }
          vis[y * w + x] = 1;
        }
      }
  }

  void pass_ref(int bp) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        for (int y = y0; y < ylim; ++y) {
          const int i = y * w + x;
          if (!s_at(x, y) || vis[i]) continue;
          const int bit = (mag[i] >> bp) & 1;
          int ci;
          if (refined[i]) {
            ci = 16;
          } else {
            int hc, vc, dc;
            neigh(x, y, &hc, &vc, &dc);
            ci = (hc + vc + dc) ? 15 : 14;
          }
          mq.encode(cx, ci, bit);
          refined[i] = 1;
          vis[i] = 1;
        }
      }
  }

  void pass_cleanup(int bp) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        const int ylim = (y0 + 4 < h) ? y0 + 4 : h;
        while (y < ylim) {
          if (y == y0 && y0 + 4 <= h) {
            bool ok = true;
            for (int yy = y0; yy < y0 + 4; ++yy) {
              if (s_at(x, yy) || vis[yy * w + x]) {
                ok = false;
                break;
              }
              int hc, vc, dc;
              neigh(x, yy, &hc, &vc, &dc);
              if (hc + vc + dc) {
                ok = false;
                break;
              }
            }
            if (ok) {
              int first = -1;
              for (int yy = y0; yy < y0 + 4; ++yy)
                if ((mag[yy * w + x] >> bp) & 1) {
                  first = yy;
                  break;
                }
              if (first < 0) {
                mq.encode(cx, kCtxRl, 0);
                y = y0 + 4;
                continue;
              }
              mq.encode(cx, kCtxRl, 1);
              const int pos = first - y0;
              mq.encode(cx, kCtxUni, (pos >> 1) & 1);
              mq.encode(cx, kCtxUni, pos & 1);
              y = first;
              int ci, xr;
              sign_ctx(x, y, &ci, &xr);
              mq.encode(cx, ci, (neg[y * w + x] ? 1 : 0) ^ xr);
              set_sig(x, y, bp);
              ++y;
              continue;
            }
          }
          if (s_at(x, y) || vis[y * w + x]) {
            ++y;
            continue;
          }
          const int bit = (mag[y * w + x] >> bp) & 1;
          int hc, vc, dc;
          neigh(x, y, &hc, &vc, &dc);
          mq.encode(cx, sig_ctx(hc, vc, dc), bit);
          if (bit) {
            int ci, xr;
            sign_ctx(x, y, &ci, &xr);
            mq.encode(cx, ci, (neg[y * w + x] ? 1 : 0) ^ xr);
            set_sig(x, y, bp);
          }
          ++y;
        }
      }
  }
};

}  // namespace j2k

extern "C" {

// Encode one code-block's coefficients (mag = |v|, neg = sign bits).
// out must hold at least `cap` bytes.  Writes *numbps/*npasses; returns
// the codeword byte length, 0 for an all-zero block, or -1 on overflow.
int64_t mdx_torch_io_jpeg2k_t1_enc(const int32_t *mag, const uint8_t *neg,
                                   int32_t w, int32_t h, int32_t btype,
                                   uint8_t *out, int64_t cap,
                                   int32_t *numbps_out,
                                   int32_t *npasses_out) {
  int32_t maxmag = 0;
  const int64_t total = static_cast<int64_t>(w) * h;
  for (int64_t i = 0; i < total; ++i)
    if (mag[i] > maxmag) maxmag = mag[i];
  int numbps = 0;
  while ((1 << numbps) <= maxmag) ++numbps;
  *numbps_out = numbps;
  if (numbps == 0) {
    *npasses_out = 0;
    return 0;
  }
  j2k::T1Enc t1(w, h, btype, mag, neg);
  t1.mq.init(out, cap);
  const int npasses = 3 * numbps - 2;
  for (int p = 0; p < npasses; ++p) {
    int kind, bp;
    if (p == 0) {
      kind = 2;
      bp = numbps - 1;
    } else {
      kind = (p - 1) % 3;
      bp = numbps - 2 - (p - 1) / 3;
    }
    if (kind == 0)
      t1.pass_sig(bp);
    else if (kind == 1)
      t1.pass_ref(bp);
    else {
      t1.pass_cleanup(bp);
      std::fill(t1.vis.begin(), t1.vis.end(), 0);
    }
  }
  *npasses_out = npasses;
  return t1.mq.flush();
}

}  // extern "C"
