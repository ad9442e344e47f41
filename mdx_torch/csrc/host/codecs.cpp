// Host-side entropy loops of the port's lossless JPEG codecs
// (mdx_torch/io/jpegll.py, mdx_torch/io/jpegls.py).
//
// The JAX package's native/mdxio.cpp holds the same four loops; this is the
// port's own copy of them, with the same C ABI under the mdx_torch_io_
// prefix, the same return codes and the same control flow, so that a stream
// decodes and encodes bit for bit as there.  The four loops are serial (one
// entropy-coded segment per call) and integer-only; mdx_torch/io/native.py
// builds this file with the host C++ compiler at first use and calls it
// through ctypes, which releases the GIL for the call, so frames decode in
// parallel on the reader's thread pool.
//
// Exposed C ABI:
//   mdx_torch_io_jpegll_diffs  : JPEG Lossless entropy decode (T.81 H/F.2)
//   mdx_torch_io_jpegll_pack   : JPEG Lossless entropy encode bit packer
//   mdx_torch_io_jpegls_decode : JPEG-LS scan decode (T.87 clause A)
//   mdx_torch_io_jpegls_encode : JPEG-LS scan encode (T.87 clause A)
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
