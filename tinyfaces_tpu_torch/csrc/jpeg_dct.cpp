// Baseline-JPEG entropy decoder of the PyTorch port: JPEG bytes -> quantized
// DCT coefficients, and their pack into the `jpegdct` wire (version 3,
// zigzag-dense).
//
// A copy of the JAX package's decoder (native/jpeg_dct.cpp), code for code,
// built on its own into a host library with the same compiler flags as the
// port's augmentation engine. Only marker parsing and Huffman entropy
// decoding run on the host; dequantization, the 8x8 IDCT, chroma upsampling
// and normalization run on the GPU (tinyfaces_tpu_torch/ops/jpeg.py).
//
// Scope: baseline + extended sequential Huffman (SOF0/SOF1), grayscale or
// YCbCr with 4:2:0 / 4:2:2 / 4:4:4 sampling, restart intervals, 8/16-bit
// quant tables. Progressive (SOF2) and arithmetic coding return an error;
// the Python caller transcodes those through PIL where PIL is installed
// and raises where it is not (tinyfaces_tpu_torch/data/jpegdct.py).
//
// Built at first use by tinyfaces_tpu_torch/utils/cuda_build.load_host_library.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int ERR_TRUNCATED = -1;
constexpr int ERR_BAD_MARKER = -2;
constexpr int ERR_UNSUPPORTED = -3;  // progressive / arithmetic / CMYK...
constexpr int ERR_BAD_HUFFMAN = -4;
constexpr int ERR_BAD_SAMPLING = -5;
constexpr int ERR_BUFFER = -6;

struct HuffTable {
  // Canonical Huffman per T.81 C.2: mincode/maxcode/valptr indexed by length.
  int32_t mincode[17];
  int32_t maxcode[17];  // -1 when no codes of this length
  int32_t valptr[17];
  uint8_t vals[256];
  uint8_t lut_sym[256];
  uint8_t lut_len[256];
  bool defined = false;
};

struct Component {
  int id = 0;
  int hs = 1, vs = 1;   // sampling factors
  int tq = 0;           // quant table id
  int td = 0, ta = 0;   // DC/AC huffman table ids
  int pred = 0;         // DC predictor
  int nbx = 0, nby = 0; // block-grid dims (component resolution)
  int16_t* out = nullptr;
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int err = 0;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  // Keep >= 49 bits buffered (one Huffman symbol + magnitude <= 32 bits
  // per refill). Handles 0xFF00 stuffing; at a marker or end-of-data it
  // synthesizes zero bytes (valid streams terminate on their own EOBs —
  // the libjpeg convention for the final lookahead).
  inline void refill() {
    if (nbits > 48) return;
    // Fast path: the next 8 bytes contain no 0xFF (no stuffing, no
    // marker), so append floor((64-nbits)/8) of them in one 64-bit op.
    // 0xFF detection is the SWAR zero-byte test applied to ~chunk.
    if (end - p >= 8) {
      uint64_t chunk;
      std::memcpy(&chunk, p, 8);
      if (!((~chunk - 0x0101010101010101ULL) & chunk &
            0x8080808080808080ULL)) {
        chunk = __builtin_bswap64(chunk);
        int take = (64 - nbits) >> 3;
        if (take == 8) {
          acc = chunk;
        } else {
          acc = (acc << (take * 8)) | (chunk >> (64 - take * 8));
        }
        p += take;
        nbits += take * 8;
        return;
      }
    }
    while (nbits <= 48) {
      uint8_t b = 0;
      if (p < end) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;  // stuffed FF
          } else {
            b = 0;  // marker (RSTn/EOI) or truncated: pad with zeros
          }
        } else {
          ++p;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline int bit1() {
    --nbits;
    return static_cast<int>((acc >> nbits) & 1);
  }

  // Byte-align and consume the expected RSTn marker (D0-D7). The buffer
  // never pulls real bytes past a marker, so p sits at (or just before)
  // it; tolerate a few pre-marker pad bytes like libjpeg's resync.
  bool restart() {
    nbits = 0;
    acc = 0;
    for (int skip = 0; skip < 16 && p + 1 < end; ++skip, ++p) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return true;
      }
    }
    err = ERR_BAD_MARKER;
    return false;
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  br.refill();
  int look = static_cast<int>((br.acc >> (br.nbits - 8)) & 0xFF);
  int l = t.lut_len[look];
  if (l) {
    br.nbits -= l;
    return t.lut_sym[look];
  }
  // rare long codes (9-16 bits): canonical walk from the 8-bit prefix
  int code = look;
  br.nbits -= 8;
  for (int len = 9; len <= 16; ++len) {
    code = (code << 1) | br.bit1();
    if (t.maxcode[len] >= 0 && code <= t.maxcode[len])
      return t.vals[t.valptr[len] + code - t.mincode[len]];
  }
  br.err = ERR_BAD_HUFFMAN;
  return 0;
}

// T.81 F.2.2.1 RECEIVE+EXTEND fused: s magnitude bits -> signed value.
// Caller's huff_decode already refilled (>= 32 bits remain).
inline int receive_extend(BitReader& br, int s) {
  if (s == 0) return 0;
  br.nbits -= s;
  int v = static_cast<int>((br.acc >> br.nbits) & ((1u << s) - 1));
  return (v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

void build_huff(HuffTable& t, const uint8_t* counts /*1..16*/,
                const uint8_t* vals, int nvals) {
  std::memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valptr[l] = k;
    t.mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    t.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  // 8-bit lookahead LUT over all codes of length <= 8 (covers ~99% of
  // symbols with typical tables): one table load per symbol.
  std::memset(t.lut_len, 0, sizeof(t.lut_len));
  code = 0;
  k = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int c = 0; c < counts[l - 1]; ++c, ++k, ++code) {
      int base = code << (8 - l);
      for (int suffix = 0; suffix < (1 << (8 - l)); ++suffix) {
        t.lut_sym[base + suffix] = t.vals[k];
        t.lut_len[base + suffix] = static_cast<uint8_t>(l);
      }
    }
    code <<= 1;
  }
  t.defined = true;
}

struct Parser {
  const uint8_t* data = nullptr;
  long len = 0;
  long pos = 0;

  Parser(const uint8_t* d, long l) : data(d), len(l) {}

  int h = 0, w = 0, ncomp = 0;
  bool progressive = false, arithmetic = false;
  int restart_interval = 0;
  Component comp[3];
  uint16_t qtab[4][64] = {};
  HuffTable hdc[4], hac[4];
  long scan_pos = -1;  // entropy data start

  int u8() { return pos < len ? data[pos++] : (pos = len + 1, 0); }
  int u16() { int a = u8(); return (a << 8) | u8(); }
  bool ok() const { return pos <= len; }

  // Parses headers up to (and including) SOS. Returns 0 or error.
  int parse() {
    if (u16() != 0xFFD8) return ERR_BAD_MARKER;  // SOI
    while (true) {
      int b = u8();
      if (!ok()) return ERR_TRUNCATED;
      if (b != 0xFF) continue;  // tolerate fill bytes
      int m = u8();
      while (m == 0xFF) m = u8();  // fill bytes before marker
      if (!ok()) return ERR_TRUNCATED;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;  // no payload
      if (m == 0xD9) return ERR_TRUNCATED;                  // EOI before SOS
      long seg_len = u16();
      long seg_end = pos + seg_len - 2;
      if (seg_len < 2 || seg_end > len) return ERR_TRUNCATED;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: {  // SOF0/1/2
          progressive = (m == 0xC2);
          if (u8() != 8) return ERR_UNSUPPORTED;  // precision
          h = u16(); w = u16();
          ncomp = u8();
          if (ncomp != 1 && ncomp != 3) return ERR_UNSUPPORTED;
          for (int c = 0; c < ncomp; ++c) {
            comp[c].id = u8();
            int hv = u8();
            comp[c].hs = hv >> 4;
            comp[c].vs = hv & 15;
            comp[c].tq = u8();
            if (comp[c].hs < 1 || comp[c].hs > 2 || comp[c].vs < 1 ||
                comp[c].vs > 2 || comp[c].tq > 3)
              return ERR_BAD_SAMPLING;
          }
          if (ncomp == 3 && (comp[1].hs != 1 || comp[1].vs != 1 ||
                             comp[2].hs != 1 || comp[2].vs != 1))
            return ERR_BAD_SAMPLING;  // chroma must be 1x1
          break;
        }
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return ERR_UNSUPPORTED;  // lossless / arithmetic / differential
        case 0xC4: {  // DHT (possibly several tables per segment)
          while (pos < seg_end) {
            int tc_th = u8();
            int tc = tc_th >> 4, th = tc_th & 15;
            if (tc > 1 || th > 3) return ERR_UNSUPPORTED;
            uint8_t counts[16];
            int nvals = 0;
            for (int i = 0; i < 16; ++i) {
              counts[i] = static_cast<uint8_t>(u8());
              nvals += counts[i];
            }
            if (nvals > 256 || pos + nvals > seg_end + 1) return ERR_TRUNCATED;
            uint8_t vals[256];
            for (int i = 0; i < nvals; ++i) vals[i] = static_cast<uint8_t>(u8());
            build_huff(tc ? hac[th] : hdc[th], counts, vals, nvals);
          }
          break;
        }
        case 0xDB: {  // DQT
          while (pos < seg_end) {
            int pq_tq = u8();
            int pq = pq_tq >> 4, tq = pq_tq & 15;
            if (tq > 3 || pq > 1) return ERR_UNSUPPORTED;
            for (int i = 0; i < 64; ++i)
              qtab[tq][i] = static_cast<uint16_t>(pq ? u16() : u8());
          }
          break;
        }
        case 0xDD:  // DRI
          restart_interval = u16();
          break;
        case 0xDA: {  // SOS
          if (progressive) return ERR_UNSUPPORTED;
          int ns = u8();
          if (ns != ncomp) return ERR_UNSUPPORTED;  // must be interleaved
          for (int i = 0; i < ns; ++i) {
            int cid = u8();
            int tdta = u8();
            for (int c = 0; c < ncomp; ++c)
              if (comp[c].id == cid) {
                comp[c].td = tdta >> 4;
                comp[c].ta = tdta & 15;
              }
          }
          u8(); u8(); u8();  // Ss, Se, Ah/Al (baseline: 0, 63, 0)
          scan_pos = pos;
          return ok() ? 0 : ERR_TRUNCATED;
        }
        default:  // APPn, COM, anything else: skip
          break;
      }
      pos = seg_end;
      if (!ok()) return ERR_TRUNCATED;
    }
  }
};

// Decode one 8x8 block into out[64] (zigzag order, quantized).
inline bool decode_block(BitReader& br, Component& c, const HuffTable& dc,
                         const HuffTable& ac, int16_t* out) {
  int t = huff_decode(br, dc);
  if (br.err) return false;
  c.pred += receive_extend(br, t);
  out[0] = static_cast<int16_t>(c.pred);
  int k = 1;
  while (k < 64) {
    int rs = huff_decode(br, ac);
    if (br.err) return false;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) { k += 16; continue; }  // ZRL
      break;                               // EOB
    }
    k += r;
    if (k > 63) { br.err = ERR_BAD_HUFFMAN; return false; }
    out[k++] = static_cast<int16_t>(receive_extend(br, s));
  }
  return true;
}

// Decode one 8x8 block DIRECTLY into the zigzag-dense wire (wire v3):
// only nonzero coefficients are touched — no intermediate block buffer,
// no zero-fill, no tail scan (EXTEND never yields 0 for s>0, so every
// decoded AC is nonzero by construction; zigzag positions past z_keep
// count as spectral truncation). Byte-equivalent to decode_block +
// pack_block on a zeroed buffer.
inline bool decode_block_pack(BitReader& br, Component& c,
                              const HuffTable& dct, const HuffTable& act,
                              long cid, int z_keep, long esc_cap,
                              int16_t* dc, int8_t* ac, int32_t* esc_idx,
                              int16_t* esc_val, long* n_esc,
                              int32_t* stats) {
  int t = huff_decode(br, dct);
  if (br.err) return false;
  c.pred += receive_extend(br, t);
  dc[cid] = static_cast<int16_t>(c.pred);
  int8_t* out = ac + cid * z_keep;
  int k = 1;
  while (k < 64) {
    int rs = huff_decode(br, act);
    if (br.err) return false;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) { k += 16; continue; }  // ZRL
      break;                               // EOB
    }
    k += r;
    if (k > 63) { br.err = ERR_BAD_HUFFMAN; return false; }
    int v = receive_extend(br, s);
    if (k <= z_keep) {
      if (v > 127 || v < -127) {
        if (*n_esc < esc_cap) {
          esc_idx[*n_esc] = static_cast<int32_t>(cid * z_keep + (k - 1));
          esc_val[*n_esc] = static_cast<int16_t>(v);
          ++*n_esc;
        } else {
          ++stats[1];
        }
        out[k - 1] = v > 0 ? 127 : -127;
      } else {
        out[k - 1] = static_cast<int8_t>(v);
      }
    } else {
      ++stats[0];  // truncated: nonzero past the zigzag cutoff
    }
    ++k;
  }
  return true;
}

// Decode one 8x8 block DIRECTLY into the bitmap-sparse wire (wire v4):
// per block a uint32 nonzero bitmap (bit k-1 = zigzag position k set),
// a uint32 offset into the plane's shared value stream, and the nonzero
// values appended to that stream as clamped int8 (|q|>127 escapes like
// v3). The stream order is whatever block order the caller visits —
// offsets ship on the wire, so the device never reconstructs it.
// Stream overflow and zigzag-tail nonzeros count as truncation.
inline bool decode_block_pack_sparse(
    BitReader& br, Component& c, const HuffTable& dct, const HuffTable& act,
    long cid, int z_keep, long esc_cap, long vcap, int16_t* dc,
    uint32_t* bitmap, int8_t* vals, int32_t* esc_idx,
    int16_t* esc_val, long* n_esc, long* n_vals, int32_t* stats) {
  int t = huff_decode(br, dct);
  if (br.err) return false;
  c.pred += receive_extend(br, t);
  dc[cid] = static_cast<int16_t>(c.pred);
  uint32_t bm = 0;
  int k = 1;
  while (k < 64) {
    int rs = huff_decode(br, act);
    if (br.err) return false;
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) { k += 16; continue; }  // ZRL
      break;                               // EOB
    }
    k += r;
    if (k > 63) { br.err = ERR_BAD_HUFFMAN; return false; }
    int v = receive_extend(br, s);
    if (k <= z_keep && *n_vals < vcap) {
      bm |= 1u << (k - 1);
      if (v > 127 || v < -127) {
        if (*n_esc < esc_cap) {
          esc_idx[*n_esc] = static_cast<int32_t>(cid * z_keep + (k - 1));
          esc_val[*n_esc] = static_cast<int16_t>(v);
          ++*n_esc;
        } else {
          ++stats[1];
        }
        vals[(*n_vals)++] = v > 0 ? 127 : -127;
      } else {
        vals[(*n_vals)++] = static_cast<int8_t>(v);
      }
    } else {
      ++stats[0];  // zigzag tail or value-stream overflow
    }
    ++k;
  }
  bitmap[cid] = bm;
  return true;
}

// Bitmap-sparse pack of one already-decoded block (wire v4 two-pass
// path); canvas-order stream. Semantics identical to
// decode_block_pack_sparse given the same visit order.
inline void pack_block_sparse(const int16_t* c, long cid, int z_keep,
                              long esc_cap, long vcap, int16_t* dc,
                              uint32_t* bitmap, int8_t* vals,
                              int32_t* esc_idx, int16_t* esc_val, long* n_esc,
                              long* n_vals, int32_t* stats) {
  dc[cid] = c[0];
  uint32_t bm = 0;
  for (int k = 1; k <= z_keep; ++k) {
    int16_t v = c[k];
    if (!v) continue;
    if (*n_vals >= vcap) {
      ++stats[0];
      continue;
    }
    bm |= 1u << (k - 1);
    if (v > 127 || v < -127) {
      if (*n_esc < esc_cap) {
        esc_idx[*n_esc] = static_cast<int32_t>(cid * z_keep + (k - 1));
        esc_val[*n_esc] = v;
        ++*n_esc;
      } else {
        ++stats[1];
      }
      vals[(*n_vals)++] = v > 0 ? 127 : -127;
    } else {
      vals[(*n_vals)++] = static_cast<int8_t>(v);
    }
  }
  for (int k = z_keep + 1; k < 64; ++k)
    if (c[k]) ++stats[0];
  bitmap[cid] = bm;
}

// Zigzag-dense pack of one decoded block (wire v3): DC int16, first
// z_keep ACs clamped int8, |q|>127 to the escape list, tail nonzeros
// counted as spectral truncation. Shared by tf_dct_pack_dense and the
// fused tf_jpeg_dct_pack so both stay bit-identical to the NumPy oracle.
inline void pack_block(const int16_t* c, long cid, int z_keep, long esc_cap,
                       int16_t* dc, int8_t* ac, int32_t* esc_idx,
                       int16_t* esc_val, long* n_esc, int32_t* stats) {
  dc[cid] = c[0];
  int8_t* out = ac + cid * z_keep;
  for (int k = 1; k <= z_keep; ++k) {
    int16_t v = c[k];
    if (!v) continue;
    if (v > 127 || v < -127) {
      if (*n_esc < esc_cap) {
        esc_idx[*n_esc] = static_cast<int32_t>(cid * z_keep + (k - 1));
        esc_val[*n_esc] = v;
        ++*n_esc;
      } else {
        ++stats[1];
      }
      out[k - 1] = v > 0 ? 127 : -127;
    } else {
      out[k - 1] = static_cast<int8_t>(v);
    }
  }
  for (int k = z_keep + 1; k < 64; ++k)
    if (c[k]) ++stats[0];
}

}  // namespace

extern "C" {

// info out (8 ints): h, w, ncomp, y_hsamp, y_vsamp, progressive,
// restart_interval, reserved. Returns 0 or negative error.
int tf_jpeg_info(const uint8_t* data, long len, int32_t* info) {
  Parser ps(data, len);
  int rc = ps.parse();
  if (rc == ERR_UNSUPPORTED && ps.h > 0) {
    // dims were parsed before the unsupported feature: still report them
    info[0] = ps.h; info[1] = ps.w; info[2] = ps.ncomp;
    info[3] = ps.comp[0].hs; info[4] = ps.comp[0].vs;
    info[5] = ps.progressive ? 1 : 0;
    info[6] = ps.restart_interval; info[7] = 0;
    return rc;
  }
  if (rc) return rc;
  info[0] = ps.h; info[1] = ps.w; info[2] = ps.ncomp;
  info[3] = ps.comp[0].hs; info[4] = ps.comp[0].vs;
  info[5] = ps.progressive ? 1 : 0;
  info[6] = ps.restart_interval; info[7] = 0;
  return 0;
}

// Entropy-decodes every component's quantized coefficients.
//   coef0/1/2: per-component dense block buffers, (nby*nbx, 64) int16 each,
//              ZIGZAG order, caller-zeroed and caller-sized; for ncomp==1
//              coef1/2 may be null.
//   qt_out: (ncomp, 64) uint16, zigzag order (component's table).
//   grid_out (8 ints): nby0, nbx0, nby1, nbx1, nby2, nbx2, mcus_y, mcus_x.
//   cap0/1/2: capacity (in blocks) of each coef buffer.
// Returns 0 or negative error.
int tf_jpeg_dct(const uint8_t* data, long len, int16_t* coef0, long cap0,
                int16_t* coef1, long cap1, int16_t* coef2, long cap2,
                uint16_t* qt_out, int32_t* grid_out) {
  Parser ps(data, len);
  int rc = ps.parse();
  if (rc) return rc;

  // T.81 A.2.3: a single-component scan is non-interleaved — the MCU is
  // ONE data unit and the sampling factors do not scale the block grid
  // (grayscale JPEGs commonly carry 2x2 factors on their lone component).
  if (ps.ncomp == 1) { ps.comp[0].hs = 1; ps.comp[0].vs = 1; }

  int hmax = 1, vmax = 1;
  for (int c = 0; c < ps.ncomp; ++c) {
    hmax = ps.comp[c].hs > hmax ? ps.comp[c].hs : hmax;
    vmax = ps.comp[c].vs > vmax ? ps.comp[c].vs : vmax;
  }
  int mcus_x = (ps.w + 8 * hmax - 1) / (8 * hmax);
  int mcus_y = (ps.h + 8 * vmax - 1) / (8 * vmax);

  int16_t* bufs[3] = {coef0, coef1, coef2};
  long caps[3] = {cap0, cap1, cap2};
  for (int c = 0; c < ps.ncomp; ++c) {
    Component& co = ps.comp[c];
    co.nbx = mcus_x * co.hs;
    co.nby = mcus_y * co.vs;
    co.out = bufs[c];
    if (!co.out || caps[c] < static_cast<long>(co.nby) * co.nbx)
      return ERR_BUFFER;
    if (!ps.hdc[co.td].defined || !ps.hac[co.ta].defined)
      return ERR_BAD_HUFFMAN;
    for (int i = 0; i < 64; ++i) qt_out[c * 64 + i] = ps.qtab[co.tq][i];
    grid_out[2 * c] = co.nby;
    grid_out[2 * c + 1] = co.nbx;
  }
  for (int c = ps.ncomp; c < 3; ++c) {
    grid_out[2 * c] = 0;
    grid_out[2 * c + 1] = 0;
  }
  grid_out[6] = mcus_y;
  grid_out[7] = mcus_x;

  BitReader br(data + ps.scan_pos, data + len);
  long mcu_count = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (ps.restart_interval && mcu_count &&
          mcu_count % ps.restart_interval == 0) {
        if (!br.restart()) return br.err;
        for (int c = 0; c < ps.ncomp; ++c) ps.comp[c].pred = 0;
      }
      for (int c = 0; c < ps.ncomp; ++c) {
        Component& co = ps.comp[c];
        for (int v = 0; v < co.vs; ++v) {
          for (int hh = 0; hh < co.hs; ++hh) {
            long by = static_cast<long>(my) * co.vs + v;
            long bx = static_cast<long>(mx) * co.hs + hh;
            int16_t* out = co.out + (by * co.nbx + bx) * 64;
            if (!decode_block(br, co, ps.hdc[co.td], ps.hac[co.ta], out))
              return br.err ? br.err : ERR_BAD_HUFFMAN;
          }
        }
      }
      ++mcu_count;
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Zigzag-dense pack (wire v3): per block, quantized DC (int16) + the
// first `z_keep` zigzag AC coefficients as clamped int8 with an escape
// list for |q| > 127. No per-slot positions or counts — the device
// reconstructs with one basis matmul (ops/jpeg.py). Coefficients past
// z_keep are dropped (spectral truncation, counted in stats[0]);
// escape-list overflow clamps (stats[1]).
//   coef_zz: (gby*gbx, 64) int16 zigzag; image grid lands at the
//   top-left of the (cnh, cnw) canvas grid; other canvas blocks get
//   neutral_dc and zero ACs.
void tf_dct_pack_dense(const int16_t* coef_zz, int gby, int gbx, int cnh,
                       int cnw, int z_keep, long esc_cap,
                       int16_t neutral_dc, int16_t* dc, int8_t* ac,
                       int32_t* esc_idx, int16_t* esc_val, int32_t* stats) {
  const long cn = static_cast<long>(cnh) * cnw;
  for (long i = 0; i < cn; ++i) dc[i] = neutral_dc;
  std::memset(ac, 0, cn * z_keep);
  for (long i = 0; i < esc_cap; ++i) esc_idx[i] = -1;
  std::memset(esc_val, 0, esc_cap * sizeof(int16_t));
  stats[0] = 0;
  stats[1] = 0;

  long n_esc = 0;
  for (int by = 0; by < gby; ++by) {
    for (int bx = 0; bx < gbx; ++bx) {
      const int16_t* c = coef_zz + (static_cast<long>(by) * gbx + bx) * 64;
      pack_block(c, static_cast<long>(by) * cnw + bx, z_keep, esc_cap,
                 dc, ac, esc_idx, esc_val, &n_esc, stats);
    }
  }
}

// Bitmap-sparse pack (wire v4): per block a uint32 nonzero bitmap +
// uint32 stream offset; nonzero values ride a shared per-plane int8
// stream of capacity `vcap` (canvas-order here). Escapes as in v3.
//   coef_zz: (gby*gbx, 64) int16 zigzag; image grid lands at the
//   top-left of the (cnh, cnw) canvas; uncovered canvas blocks get
//   neutral_dc, bitmap 0, offset 0.
void tf_dct_pack_sparse(const int16_t* coef_zz, int gby, int gbx, int cnh,
                        int cnw, int z_keep, long esc_cap, long vcap,
                        int16_t neutral_dc, int16_t* dc, uint32_t* bitmap,
                        int8_t* vals, int32_t* esc_idx,
                        int16_t* esc_val, int32_t* stats) {
  const long cn = static_cast<long>(cnh) * cnw;
  for (long i = 0; i < cn; ++i) dc[i] = neutral_dc;
  std::memset(bitmap, 0, cn * sizeof(uint32_t));
  std::memset(vals, 0, vcap);
  for (long i = 0; i < esc_cap; ++i) esc_idx[i] = -1;
  std::memset(esc_val, 0, esc_cap * sizeof(int16_t));
  stats[0] = 0;
  stats[1] = 0;

  long n_esc = 0, n_vals = 0;
  for (int by = 0; by < gby; ++by) {
    for (int bx = 0; bx < gbx; ++bx) {
      const int16_t* c = coef_zz + (static_cast<long>(by) * gbx + bx) * 64;
      pack_block_sparse(c, static_cast<long>(by) * cnw + bx, z_keep, esc_cap,
                        vcap, dc, bitmap, vals, esc_idx, esc_val,
                        &n_esc, &n_vals, stats);
    }
  }
}

// Fused entropy-decode + bitmap-sparse pack (wire v4): JPEG bytes ->
// v4 wire fields in one pass (MCU-order value streams — offsets ship on
// the wire so the order is free). Same scope/fallback contract as
// tf_jpeg_dct_pack. Initializes every output region it owns.
int tf_jpeg_dct_pack_sparse(
    const uint8_t* data, long len, int cnh8, int cnw8, int z_keep_y,
    int z_keep_c, long esc_cap_y, long esc_cap_c, long vcap_y, long vcap_c,
    float neutral_y, float neutral_cb, float neutral_cr, int16_t* y_dc,
    uint32_t* y_bm, int8_t* y_vals, int32_t* y_esc_idx,
    int16_t* y_esc_val, int16_t* u_dc, uint32_t* u_bm,
    int8_t* u_vals, int32_t* u_esc_idx, int16_t* u_esc_val, int16_t* v_dc,
    uint32_t* v_bm, int8_t* v_vals, int32_t* v_esc_idx,
    int16_t* v_esc_val, uint16_t* q_y, uint16_t* q_c, int32_t* hw_out,
    int32_t* stats) {
  Parser ps(data, len);
  int rc = ps.parse();
  if (rc) return rc;
  if (ps.ncomp == 1) {
    ps.comp[0].hs = 1;
    ps.comp[0].vs = 1;
  } else if (ps.comp[0].hs != 2 || ps.comp[0].vs != 2) {
    return ERR_BAD_SAMPLING;  // fused path is 4:2:0-only
  }
  const int hs = ps.comp[0].hs, vs = ps.comp[0].vs;
  const int mcus_x = (ps.w + 8 * hs - 1) / (8 * hs);
  const int mcus_y = (ps.h + 8 * vs - 1) / (8 * vs);
  const int cnh16 = cnh8 / 2, cnw16 = cnw8 / 2;
  if (mcus_y * vs > cnh8 || mcus_x * hs > cnw8) return ERR_BUFFER;
  if (ps.ncomp == 3 && (mcus_y > cnh16 || mcus_x > cnw16)) return ERR_BUFFER;
  for (int c = 0; c < ps.ncomp; ++c)
    if (!ps.hdc[ps.comp[c].td].defined || !ps.hac[ps.comp[c].ta].defined)
      return ERR_BAD_HUFFMAN;

  for (int i = 0; i < 64; ++i) {
    q_y[i] = ps.qtab[ps.comp[0].tq][i];
    q_c[i] = ps.ncomp == 3 ? ps.qtab[ps.comp[1].tq][i] : q_y[i];
  }
  const auto flat_dc = [](float v, uint16_t q) {
    return static_cast<int16_t>(
        std::lround(8.0 * (v - 128.0) / (q ? q : 1)));
  };
  const int16_t ndc_y = flat_dc(neutral_y, q_y[0]);
  const int16_t ndc_u = ps.ncomp == 3 ? flat_dc(neutral_cb, q_c[0])
                                      : static_cast<int16_t>(0);
  const int16_t ndc_v = ps.ncomp == 3 ? flat_dc(neutral_cr, q_c[0])
                                      : static_cast<int16_t>(0);

  const long cny = static_cast<long>(cnh8) * cnw8;
  const long cnc = static_cast<long>(cnh16) * cnw16;
  for (long i = 0; i < cny; ++i) y_dc[i] = ndc_y;
  for (long i = 0; i < cnc; ++i) u_dc[i] = ndc_u;
  for (long i = 0; i < cnc; ++i) v_dc[i] = ndc_v;
  std::memset(y_bm, 0, cny * sizeof(uint32_t));
  std::memset(u_bm, 0, cnc * sizeof(uint32_t));
  std::memset(v_bm, 0, cnc * sizeof(uint32_t));
  std::memset(y_vals, 0, vcap_y);
  std::memset(u_vals, 0, vcap_c);
  std::memset(v_vals, 0, vcap_c);
  for (long i = 0; i < esc_cap_y; ++i) y_esc_idx[i] = -1;
  for (long i = 0; i < esc_cap_c; ++i) u_esc_idx[i] = -1;
  for (long i = 0; i < esc_cap_c; ++i) v_esc_idx[i] = -1;
  std::memset(y_esc_val, 0, esc_cap_y * sizeof(int16_t));
  std::memset(u_esc_val, 0, esc_cap_c * sizeof(int16_t));
  std::memset(v_esc_val, 0, esc_cap_c * sizeof(int16_t));
  stats[0] = 0;
  stats[1] = 0;

  int16_t* dcs[3] = {y_dc, u_dc, v_dc};
  uint32_t* bms[3] = {y_bm, u_bm, v_bm};
  int8_t* vss[3] = {y_vals, u_vals, v_vals};
  int32_t* eis[3] = {y_esc_idx, u_esc_idx, v_esc_idx};
  int16_t* evs[3] = {y_esc_val, u_esc_val, v_esc_val};
  const long ecaps[3] = {esc_cap_y, esc_cap_c, esc_cap_c};
  const long vcaps[3] = {vcap_y, vcap_c, vcap_c};
  const int zks[3] = {z_keep_y, z_keep_c, z_keep_c};
  const int cnws[3] = {cnw8, cnw16, cnw16};
  long n_esc[3] = {0, 0, 0};
  long n_vals[3] = {0, 0, 0};

  BitReader br(data + ps.scan_pos, data + len);
  long mcu_count = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (ps.restart_interval && mcu_count &&
          mcu_count % ps.restart_interval == 0) {
        if (!br.restart()) return br.err;
        for (int c = 0; c < ps.ncomp; ++c) ps.comp[c].pred = 0;
      }
      for (int c = 0; c < ps.ncomp; ++c) {
        Component& co = ps.comp[c];
        for (int v = 0; v < co.vs; ++v) {
          for (int hh = 0; hh < co.hs; ++hh) {
            const long by = static_cast<long>(my) * co.vs + v;
            const long bx = static_cast<long>(mx) * co.hs + hh;
            if (!decode_block_pack_sparse(
                    br, co, ps.hdc[co.td], ps.hac[co.ta], by * cnws[c] + bx,
                    zks[c], ecaps[c], vcaps[c], dcs[c], bms[c],
                    vss[c], eis[c], evs[c], &n_esc[c], &n_vals[c], stats))
              return br.err ? br.err : ERR_BAD_HUFFMAN;
          }
        }
      }
      ++mcu_count;
    }
  }
  hw_out[0] = ps.h;
  hw_out[1] = ps.w;
  hw_out[2] = ps.ncomp;  // 3 -> Y stream in MCU order; 1 -> row order
  return 0;
}

// Fused entropy-decode + zigzag-dense pack: JPEG bytes -> wire fields
// directly, skipping the intermediate (nblocks, 64) int16 coefficient
// buffers of tf_jpeg_dct + tf_dct_pack_dense (a ~1.5 MB/image write +
// re-read on the single-core host). Baseline 4:2:0 color or grayscale
// only — anything else returns an error and the caller takes the
// transcode + two-pass path.
//   cnh8/cnw8: Y canvas block grid (h0p/8, w0p/8); chroma uses half.
//   neutral_*: canvas fill in YCbCr pixel domain; uncovered canvas
//   blocks get the flat-block quantized DC round(8*(v-128)/q[0]).
//   Grayscale: chroma planes get DC 0 (=128 gray) and q_c = q_y.
//   hw_out: [h, w, ncomp]. stats: [truncated_coeffs, clamped_escapes].
// Initializes every output region it owns (caller may pass
// uninitialized memory). Returns 0 or a negative error.
int tf_jpeg_dct_pack(const uint8_t* data, long len, int cnh8, int cnw8,
                     int z_keep_y, int z_keep_c, long esc_cap_y,
                     long esc_cap_c, float neutral_y, float neutral_cb,
                     float neutral_cr, int16_t* y_dc, int8_t* y_ac,
                     int32_t* y_esc_idx, int16_t* y_esc_val, int16_t* u_dc,
                     int8_t* u_ac, int32_t* u_esc_idx, int16_t* u_esc_val,
                     int16_t* v_dc, int8_t* v_ac, int32_t* v_esc_idx,
                     int16_t* v_esc_val, uint16_t* q_y, uint16_t* q_c,
                     int32_t* hw_out, int32_t* stats) {
  Parser ps(data, len);
  int rc = ps.parse();
  if (rc) return rc;
  // Single-component scans are non-interleaved (T.81 A.2.3): sampling
  // factors don't scale the block grid.
  if (ps.ncomp == 1) {
    ps.comp[0].hs = 1;
    ps.comp[0].vs = 1;
  } else if (ps.comp[0].hs != 2 || ps.comp[0].vs != 2) {
    return ERR_BAD_SAMPLING;  // fused path is 4:2:0-only
  }
  const int hs = ps.comp[0].hs, vs = ps.comp[0].vs;
  const int mcus_x = (ps.w + 8 * hs - 1) / (8 * hs);
  const int mcus_y = (ps.h + 8 * vs - 1) / (8 * vs);
  const int cnh16 = cnh8 / 2, cnw16 = cnw8 / 2;
  if (mcus_y * vs > cnh8 || mcus_x * hs > cnw8) return ERR_BUFFER;
  if (ps.ncomp == 3 && (mcus_y > cnh16 || mcus_x > cnw16)) return ERR_BUFFER;
  for (int c = 0; c < ps.ncomp; ++c)
    if (!ps.hdc[ps.comp[c].td].defined || !ps.hac[ps.comp[c].ta].defined)
      return ERR_BAD_HUFFMAN;

  for (int i = 0; i < 64; ++i) {
    q_y[i] = ps.qtab[ps.comp[0].tq][i];
    q_c[i] = ps.ncomp == 3 ? ps.qtab[ps.comp[1].tq][i] : q_y[i];
  }
  const auto flat_dc = [](float v, uint16_t q) {
    return static_cast<int16_t>(
        std::lround(8.0 * (v - 128.0) / (q ? q : 1)));
  };
  const int16_t ndc_y = flat_dc(neutral_y, q_y[0]);
  const int16_t ndc_u = ps.ncomp == 3 ? flat_dc(neutral_cb, q_c[0])
                                      : static_cast<int16_t>(0);
  const int16_t ndc_v = ps.ncomp == 3 ? flat_dc(neutral_cr, q_c[0])
                                      : static_cast<int16_t>(0);

  const long cny = static_cast<long>(cnh8) * cnw8;
  const long cnc = static_cast<long>(cnh16) * cnw16;
  for (long i = 0; i < cny; ++i) y_dc[i] = ndc_y;
  for (long i = 0; i < cnc; ++i) u_dc[i] = ndc_u;
  for (long i = 0; i < cnc; ++i) v_dc[i] = ndc_v;
  std::memset(y_ac, 0, cny * z_keep_y);
  std::memset(u_ac, 0, cnc * z_keep_c);
  std::memset(v_ac, 0, cnc * z_keep_c);
  for (long i = 0; i < esc_cap_y; ++i) y_esc_idx[i] = -1;
  for (long i = 0; i < esc_cap_c; ++i) u_esc_idx[i] = -1;
  for (long i = 0; i < esc_cap_c; ++i) v_esc_idx[i] = -1;
  std::memset(y_esc_val, 0, esc_cap_y * sizeof(int16_t));
  std::memset(u_esc_val, 0, esc_cap_c * sizeof(int16_t));
  std::memset(v_esc_val, 0, esc_cap_c * sizeof(int16_t));
  stats[0] = 0;
  stats[1] = 0;

  int16_t* dcs[3] = {y_dc, u_dc, v_dc};
  int8_t* acs[3] = {y_ac, u_ac, v_ac};
  int32_t* eis[3] = {y_esc_idx, u_esc_idx, v_esc_idx};
  int16_t* evs[3] = {y_esc_val, u_esc_val, v_esc_val};
  const long caps[3] = {esc_cap_y, esc_cap_c, esc_cap_c};
  const int zks[3] = {z_keep_y, z_keep_c, z_keep_c};
  const int cnws[3] = {cnw8, cnw16, cnw16};
  long n_esc[3] = {0, 0, 0};

  BitReader br(data + ps.scan_pos, data + len);
  long mcu_count = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (ps.restart_interval && mcu_count &&
          mcu_count % ps.restart_interval == 0) {
        if (!br.restart()) return br.err;
        for (int c = 0; c < ps.ncomp; ++c) ps.comp[c].pred = 0;
      }
      for (int c = 0; c < ps.ncomp; ++c) {
        Component& co = ps.comp[c];
        for (int v = 0; v < co.vs; ++v) {
          for (int hh = 0; hh < co.hs; ++hh) {
            const long by = static_cast<long>(my) * co.vs + v;
            const long bx = static_cast<long>(mx) * co.hs + hh;
            if (!decode_block_pack(br, co, ps.hdc[co.td], ps.hac[co.ta],
                                   by * cnws[c] + bx, zks[c], caps[c],
                                   dcs[c], acs[c], eis[c], evs[c],
                                   &n_esc[c], stats))
              return br.err ? br.err : ERR_BAD_HUFFMAN;
          }
        }
      }
      ++mcu_count;
    }
  }
  hw_out[0] = ps.h;
  hw_out[1] = ps.w;
  return 0;
}

}  // extern "C"
