// Native host-side codec core for airs_compression_tpu.
//
// The device owns the batched data path (ops/); this library is the host
// runtime's fast path: the CLI and the host codec use it for scalar
// encode/pack, sequential Golomb decode, and XXH32 checksums, with a pure
// Python fallback when the shared library is unavailable.
//
// The bitstream semantics implemented here are the AIRSPACE format's
// (MSB-first big-endian, zigzag + Golomb ZERO/MULTI with escapes) as
// specified by the reference encoder (lib/compress/encoder.c:303-378,
// lib/common/bitstream_writer.h) — written from scratch against the same
// format description used by engine/host.py, and differential-tested
// against both that module and the reference C oracle.
//
// Exposed via a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// --------------------------------------------------------------------------
// XXH32 (public algorithm, xxHash spec) — checksum of sample bytes.
// --------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                      P4 = 668265263u, P5 = 374761393u;

static inline uint32_t read32le(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    v = __builtin_bswap32(v);
#endif
    return v;
}

uint32_t airs_xxh32(const uint8_t* data, uint64_t len, uint32_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* limit = end - 16;
        do {
            v1 = rotl32(v1 + read32le(p) * P2, 13) * P1; p += 4;
            v2 = rotl32(v2 + read32le(p) * P2, 13) * P1; p += 4;
            v3 = rotl32(v3 + read32le(p) * P2, 13) * P1; p += 4;
            v4 = rotl32(v4 + read32le(p) * P2, 13) * P1; p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h = rotl32(h + read32le(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p) * P5, 11) * P1;
        ++p;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

// Checksum of n u16 samples as big-endian byte pairs (AIRSPACE convention,
// reference lib/common/header.c:137-163).
uint32_t airs_checksum_u16(const uint16_t* samples, uint64_t n, uint32_t seed) {
    // stream the BE conversion through a small stack buffer
    uint8_t buf[4096];
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    uint64_t total = n * 2;
    uint64_t consumed = 0;
    uint32_t h;
    // big chunks of 16 bytes through the lanes
    uint64_t i = 0;
    bool used_lanes = total >= 16;
    while (i + 8 <= n) {  // 8 samples = 16 bytes per stripe
        for (int k = 0; k < 8; ++k) {
            uint16_t s = samples[i + k];
            buf[2 * k] = (uint8_t)(s >> 8);
            buf[2 * k + 1] = (uint8_t)s;
        }
        v1 = rotl32(v1 + read32le(buf) * P2, 13) * P1;
        v2 = rotl32(v2 + read32le(buf + 4) * P2, 13) * P1;
        v3 = rotl32(v3 + read32le(buf + 8) * P2, 13) * P1;
        v4 = rotl32(v4 + read32le(buf + 12) * P2, 13) * P1;
        i += 8;
        consumed += 16;
    }
    if (used_lanes)
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    else
        h = seed + P5;
    h += (uint32_t)total;
    // tail samples (< 8)
    uint8_t tail[16];
    int t = 0;
    for (; i < n; ++i) {
        uint16_t s = samples[i];
        tail[t++] = (uint8_t)(s >> 8);
        tail[t++] = (uint8_t)s;
    }
    int ti = 0;
    while (ti + 4 <= t) {
        h = rotl32(h + read32le(tail + ti) * P3, 17) * P4;
        ti += 4;
    }
    while (ti < t) {
        h = rotl32(h + tail[ti] * P5, 11) * P1;
        ++ti;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

// --------------------------------------------------------------------------
// Bit writer (MSB-first big-endian), buffer assumed large enough by caller.
// --------------------------------------------------------------------------

struct BitWriter {
    uint8_t* buf;
    uint64_t bitpos;
};

static inline void put_bits(BitWriter& bw, uint32_t value, unsigned nbits) {
    // write nbits of value (MSB-first) at bw.bitpos
    uint64_t pos = bw.bitpos;
    bw.bitpos += nbits;
    while (nbits) {
        unsigned byte = (unsigned)(pos >> 3);
        unsigned avail = 8 - (unsigned)(pos & 7);
        unsigned take = nbits < avail ? nbits : avail;
        unsigned shift = avail - take;
        uint8_t bits = (uint8_t)((value >> (nbits - take)) & ((1u << take) - 1));
        bw.buf[byte] |= (uint8_t)(bits << shift);
        pos += take;
        nbits -= take;
    }
}

static inline unsigned ilog2_u32(uint32_t x) {
    return 31 - (unsigned)__builtin_clz(x);
}

static inline void golomb_put(BitWriter& bw, uint32_t value, uint32_t g_par,
                              unsigned g_log2, uint32_t cutoff) {
    if (value < cutoff) {
        put_bits(bw, value, g_log2 + 1);
    } else {
        uint32_t group = (value - cutoff) / g_par;
        uint32_t rem = (value - cutoff) - group * g_par;
        unsigned len = g_log2 + 1;
        uint32_t cw = (((1u << group) - 1u) << (len + 1)) + (cutoff << 1) + rem;
        put_bits(bw, cw, len + 1 + group);
    }
}

// Encode n int16 residuals starting at start_bit in dst (dst must be
// zeroed and large enough: worst case 48 bits/sample).  enc_type:
// 0 = uncompressed, 1 = Golomb zero-escape, 2 = Golomb multi-escape.
// Returns the end bit position.
uint64_t airs_encode_residuals(const int16_t* residuals, uint64_t n,
                               uint32_t enc_type, uint32_t g_par,
                               uint32_t outlier, uint8_t* dst,
                               uint64_t start_bit) {
    BitWriter bw{dst, start_bit};
    if (enc_type == 0) {
        for (uint64_t i = 0; i < n; ++i)
            put_bits(bw, (uint16_t)residuals[i], 16);
        return bw.bitpos;
    }
    unsigned g_log2 = ilog2_u32(g_par);
    uint32_t cutoff = (2u << g_log2) - g_par;
    if (enc_type == 1) {
        for (uint64_t i = 0; i < n; ++i) {
            int32_t v = residuals[i];
            uint32_t mapped = (uint16_t)((v << 1) ^ (v >> 15));
            if (mapped < outlier)
                golomb_put(bw, mapped + 1, g_par, g_log2, cutoff);
            else
                put_bits(bw, mapped, g_log2 + 1 + 16);
        }
    } else {
        for (uint64_t i = 0; i < n; ++i) {
            int32_t v = residuals[i];
            uint32_t mapped = (uint16_t)((v << 1) ^ (v >> 15));
            if (mapped < outlier) {
                golomb_put(bw, mapped, g_par, g_log2, cutoff);
            } else {
                uint32_t diff = mapped - outlier;
                unsigned level = diff < 4 ? 0 : ilog2_u32(diff) / 2;
                golomb_put(bw, outlier + level, g_par, g_log2, cutoff);
                put_bits(bw, diff, (level + 1) * 2);
            }
        }
    }
    return bw.bitpos;
}

// --------------------------------------------------------------------------
// Bit reader + sequential Golomb decode (the decoder the reference lacks).
// --------------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;
    uint64_t bitpos;
    uint64_t bitlen;
};

static inline uint32_t peek_bit(BitReader& br) {
    uint64_t p = br.bitpos;
    return (br.buf[p >> 3] >> (7 - (p & 7))) & 1u;
}

static inline uint32_t get_bits(BitReader& br, unsigned nbits) {
    uint32_t v = 0;
    uint64_t pos = br.bitpos;
    br.bitpos += nbits;
    while (nbits) {
        unsigned byte = (unsigned)(pos >> 3);
        unsigned avail = 8 - (unsigned)(pos & 7);
        unsigned take = nbits < avail ? nbits : avail;
        unsigned shift = avail - take;
        v = (v << take) | ((br.buf[byte] >> shift) & ((1u << take) - 1));
        pos += take;
        nbits -= take;
    }
    return v;
}

// Decode n codewords from src starting at start_bit; writes the
// zigzag-mapped (or raw, for uncompressed mode) 16-bit values to out.
// Returns the end bit position, or UINT64_MAX on malformed input.
uint64_t airs_decode_mapped(const uint8_t* src, uint64_t src_bits,
                            uint64_t start_bit, uint64_t n, uint32_t enc_type,
                            uint32_t g_par, uint32_t outlier, uint16_t* out) {
    BitReader br{src, start_bit, src_bits};
    const uint64_t FAIL = ~0ull;
    if (enc_type == 0) {
        if (start_bit + 16 * n > src_bits) return FAIL;
        for (uint64_t i = 0; i < n; ++i)
            out[i] = (uint16_t)get_bits(br, 16);
        return br.bitpos;
    }
    unsigned g_log2 = ilog2_u32(g_par);
    uint32_t cutoff = (2u << g_log2) - g_par;
    for (uint64_t i = 0; i < n; ++i) {
        // unary quotient
        uint32_t q = 0;
        for (;;) {
            if (br.bitpos >= br.bitlen) return FAIL;
            if (!get_bits(br, 1)) break;
            if (++q > 32) return FAIL;
        }
        uint32_t gbits = q + 1 + g_log2;
        uint32_t r = 0;
        if (g_log2) {
            if (br.bitpos + g_log2 > br.bitlen) return FAIL;
            r = get_bits(br, g_log2);
        }
        if (r >= cutoff) {
            if (br.bitpos + 1 > br.bitlen) return FAIL;
            r = ((r << 1) | get_bits(br, 1)) - cutoff;
            gbits += 1;
        }
        // no conforming encoder emits a Golomb part wider than the
        // 32-bit codeword cap (reference encoder.h:17-30)
        if (gbits > 32) return FAIL;
        uint32_t v = q * g_par + r;
        if (enc_type == 1) {  // zero escape
            if (v == 0) {
                if (br.bitpos + 16 > br.bitlen) return FAIL;
                out[i] = (uint16_t)get_bits(br, 16);
            } else {
                if (v - 1 > 0xFFFFu) return FAIL;  // non-emittable value
                out[i] = (uint16_t)(v - 1);
            }
        } else {  // multi escape
            if (v >= outlier) {
                uint32_t level = v - outlier;
                unsigned nb = (level + 1) * 2;
                if (nb > 32 || br.bitpos + nb > br.bitlen) return FAIL;
                uint64_t val = (uint64_t)outlier + get_bits(br, nb);
                if (val > 0xFFFFu) return FAIL;  // non-emittable value
                out[i] = (uint16_t)val;
            } else {
                if (v > 0xFFFFu) return FAIL;
                out[i] = (uint16_t)v;
            }
        }
    }
    return br.bitpos;
}

// Scatter a joined byte stream into fixed-stride rows and zero-fill each
// row tail, so the (B, stride) buffer needs no prior memset (the batch
// decode tier's frame staging: rows are whole frames; the per-row Python
// copy loop — and later the full-buffer np.zeros — were measurable
// shares of wrapper decode staging).
void airs_scatter_rows(const uint8_t* joined, const int64_t* lens,
                       int64_t b, int64_t stride, uint8_t* out) {
    const uint8_t* p = joined;
    for (int64_t i = 0; i < b; ++i) {
        int64_t len = lens[i];
        int64_t take = len > stride ? stride : len;
        if (take < 0) take = 0;
        uint8_t* row = out + i * stride;
        if (take > 0) std::memcpy(row, p, (size_t)take);
        if (take < stride) std::memset(row + take, 0, (size_t)(stride - take));
        p += len;
    }
}

// Same, with explicit per-row source offsets into ``src`` — the
// concatenated-stream (file) decode path stages blocks straight from
// the stream buffer without materializing per-block slices (and without
// the host-side join, making it the cheapest staging entry).
void airs_scatter_rows_at(const uint8_t* src, const int64_t* offs,
                          const int64_t* lens, int64_t b, int64_t stride,
                          uint8_t* out) {
    for (int64_t i = 0; i < b; ++i) {
        int64_t take = lens[i] > stride ? stride : lens[i];
        if (take < 0) take = 0;
        uint8_t* row = out + i * stride;
        if (take > 0) std::memcpy(row, src + offs[i], (size_t)take);
        if (take < stride) std::memset(row + take, 0, (size_t)(stride - take));
    }
}

// Inverse of airs_scatter_rows: gather the first lens[i] bytes of each
// fixed-stride row into one contiguous stream (the encode wrapper's
// frame-extraction hot path; rows are complete big-endian frames).
// Returns the number of bytes written.
int64_t airs_gather_rows(const uint8_t* rows, const int64_t* lens, int64_t b,
                         int64_t stride, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < b; ++i) {
        int64_t take = lens[i] > stride ? stride : lens[i];
        if (take > 0) {
            std::memcpy(p, rows + i * stride, (size_t)take);
            p += take;
        }
    }
    return (int64_t)(p - out);
}

// --------------------------------------------------------------------------
// Batched header parse + validation for the staged decode tiers.
//
// One pass over B staged frame rows replaces the wrapper's vectorized-
// numpy parse/validate/trailer block (which was the dominant staging
// cost at B=1024: ~30 numpy kernel launches over tiny columns).  Field
// offsets per the AIRSPACE header layout (reference lib/cmp_header.h:
// 26-62, lib/common/header.c:89-134); the check list and its order are
// EXACTLY models/stream.BatchDecompressor._stage_from_buf's: the first
// row with any failure reports its own first failing check.
//
// Returns 0 on success; otherwise (failing_check_rank + 1), with
// *fail_block set to the offending row.  On success *uniform is set to 1
// when every row shares row 0's method byte and encoder parameters (the
// common lockstep case — lets the decode dispatcher skip its group scan).
// --------------------------------------------------------------------------

static inline uint32_t be16(const uint8_t* p) {
    return ((uint32_t)p[0] << 8) | p[1];
}

static inline uint32_t be24(const uint8_t* p) {
    return ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
}

int32_t airs_stage_parse(const uint8_t* buf, const int64_t* lens, int64_t b,
                         int64_t stride, int64_t n_samples,
                         int32_t* prep, int32_t* enc, int32_t* cs,
                         int32_t* seq, uint32_t* g, uint32_t* outlier,
                         int64_t* csize, uint32_t* stored,
                         int64_t* fail_block, int32_t* uniform) {
    *uniform = 1;
    for (int64_t i = 0; i < b; ++i) {
        const uint8_t* h = buf + i * stride;
        int64_t len = lens[i];
        uint32_t method = h[15];
        int32_t pp = (method >> 4) & 0xF;
        int32_t et = method & 0x7;
        int ext = (pp != 0) || (et != 0);
        int64_t cz = (int64_t)be24(h + 2);
        uint32_t gp = ext ? be16(h + 17) : 0;
        int rank = -1;
        if (len < 16) rank = 0;
        else if (ext && len < 22) rank = 1;
        else if (len < cz) rank = 2;
        else if ((int64_t)be24(h + 5) != 2 * n_samples) rank = 3;
        else if (pp > 3 || et > 2) rank = 4;
        else if (et != 0 && !(1 <= gp && gp <= 0xFFFF)) rank = 5;
        else if (pp == 3 && h[14] == 0) rank = 6;
        if (rank >= 0) {
            *fail_block = i;
            return rank + 1;
        }
        prep[i] = pp;
        enc[i] = et;
        cs[i] = (method >> 3) & 1;
        seq[i] = h[14];
        g[i] = gp;
        outlier[i] = ext ? be24(h + 19) : 0;
        csize[i] = cz;
        if (i > 0 && (method != buf[15] || gp != g[0]
                      || outlier[i] != outlier[0]))
            *uniform = 0;
        if (cs[i]) {
            // trailing BE u32 at csize - 4; per-byte indices clamped to
            // [0, stride) exactly like the numpy path's np.clip (a tiny
            // csize passes the checks above and is rejected later by the
            // decode end-position guard)
            uint32_t v = 0;
            for (int k = 0; k < 4; ++k) {
                int64_t idx = cz - 4 + k;
                if (idx < 0) idx = 0;
                if (idx >= stride) idx = stride - 1;
                v = (v << 8) | h[idx];
            }
            stored[i] = v;
        } else {
            stored[i] = 0;
        }
    }
    return 0;
}

// Header parse/validate straight from the CONTIGUOUS stream at per-row
// byte offsets — the device-staged decode tier's host side.  Identical
// check list/order to airs_stage_parse, but no scattered row buffer
// exists: bytes past a frame's length read as 0 (matching the scatter's
// zero tails) and the trailer clamps within the frame span.  The host
// touches ~30 bytes per frame instead of scattering the whole payload;
// the row gather/alignment happens on device inside the decode dispatch.
int32_t airs_stage_parse_at(const uint8_t* src, const int64_t* offs,
                            const int64_t* lens, int64_t b,
                            int64_t n_samples,
                            int32_t* prep, int32_t* enc, int32_t* cs,
                            int32_t* seq, uint32_t* g, uint32_t* outlier,
                            int64_t* csize, uint32_t* stored,
                            int64_t* fail_block, int32_t* uniform) {
    *uniform = 1;
    uint32_t method0 = 0, g0 = 0, o0 = 0;
    for (int64_t i = 0; i < b; ++i) {
        const uint8_t* h = src + offs[i];
        int64_t len = lens[i];
        // bounded header-byte reads: 0 past the frame's end
        uint8_t hb[22];
        for (int k = 0; k < 22; ++k) hb[k] = k < len ? h[k] : 0;
        uint32_t method = hb[15];
        int32_t pp = (method >> 4) & 0xF;
        int32_t et = method & 0x7;
        int ext = (pp != 0) || (et != 0);
        int64_t cz = (int64_t)be24(hb + 2);
        uint32_t gp = ext ? be16(hb + 17) : 0;
        int rank = -1;
        if (len < 16) rank = 0;
        else if (ext && len < 22) rank = 1;
        else if (len < cz) rank = 2;
        else if ((int64_t)be24(hb + 5) != 2 * n_samples) rank = 3;
        else if (pp > 3 || et > 2) rank = 4;
        else if (et != 0 && !(1 <= gp && gp <= 0xFFFF)) rank = 5;
        else if (pp == 3 && hb[14] == 0) rank = 6;
        if (rank >= 0) {
            *fail_block = i;
            return rank + 1;
        }
        prep[i] = pp;
        enc[i] = et;
        cs[i] = (method >> 3) & 1;
        seq[i] = hb[14];
        g[i] = gp;
        uint32_t ol = ext ? be24(hb + 19) : 0;
        outlier[i] = ol;
        csize[i] = cz;
        if (i == 0) { method0 = method; g0 = gp; o0 = ol; }
        else if (method != method0 || gp != g0 || ol != o0) *uniform = 0;
        if (cs[i]) {
            // trailing BE u32 at csize - 4, byte indices clamped within
            // the frame span (mirrors the scattered path's clamp)
            uint32_t v = 0;
            for (int k = 0; k < 4; ++k) {
                int64_t idx = cz - 4 + k;
                if (idx < 0) idx = 0;
                if (idx >= len) idx = len - 1;
                v = (v << 8) | h[idx];
            }
            stored[i] = v;
        } else {
            stored[i] = 0;
        }
    }
    return 0;
}

}  // extern "C"
