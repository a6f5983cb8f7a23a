// Native host kernels for pyrecode_tpu.
//
// Counterpart of the reference's CPython extension
// `c_recode` (pyrecode/pyrecode.cpp + c_extensions/reader.h): the decode and
// bit-packing hot loops that run on the *host* side of the pipeline (the
// device side is JAX/XLA).  Fresh implementation, word-oriented instead of
// the reference's per-bit loops:
//
//  * unpack_frame_sparse: scan the bit-packed binary map 64 bits at a time,
//    using count-trailing-zeros to jump between set bits; intensities are
//    extracted with unaligned 64-bit window reads.
//  * bit_pack_u16 / bit_unpack_u64: LSB-first b-bit streams via a 64-bit
//    shift register (one store per 8 output bytes instead of per bit).
//
// Wire format identical to reader.h:10-140 (LSB-first everywhere).
//
// Build: g++ -O3 -march=native -shared -fPIC recode_host.cpp -o librecode_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

#if defined(_MSC_VER)
#include <intrin.h>
static inline int ctz64(uint64_t x) { unsigned long i; _BitScanForward64(&i, x); return (int)i; }
#else
static inline int ctz64(uint64_t x) { return __builtin_ctzll(x); }
#endif

static inline uint64_t load_le64(const uint8_t *p) {
    uint64_t v;
    std::memcpy(&v, p, sizeof(v));
    return v;  // little-endian hosts only (x86/arm64)
}

extern "C" {

// Decode one frame's packed streams into sparse (row, col, value) u64 triplets.
// bitmap: ceil(n_pixels/8) bytes, row-major LSB-first.
// pixvals: bit_depth-bit LSB-first stream (may be null for levels 2-4, where
// the emitted value is 1, matching reader.h:39-41).
// out: capacity >= 3 * n_foreground u64.  Returns the foreground count.
int64_t unpack_frame_sparse(uint32_t ny, uint32_t nx, uint8_t bit_depth,
                            const uint8_t *bitmap, const uint8_t *pixvals,
                            uint64_t *out, int32_t reduction_level) {
    const uint64_t n_pixels = (uint64_t)ny * nx;
    const uint64_t n_words = n_pixels / 64;
    const uint64_t mask_val = bit_depth >= 64 ? ~0ULL : ((1ULL << bit_depth) - 1);
    const int with_values = (reduction_level == 1) && pixvals != nullptr;

    uint64_t n_fg = 0;
    uint64_t *o = out;

    auto emit_range = [&](uint64_t word, uint64_t base) {
        while (word) {
            const int bit = ctz64(word);
            word &= word - 1;
            const uint64_t idx = base + (uint64_t)bit;
            uint64_t value = 1;
            if (with_values) {
                const uint64_t bitpos = n_fg * bit_depth;
                // unaligned 64-bit window covers any <=57-bit value at any
                // bit offset; bit_depth <= 56 guaranteed by the container
                const uint64_t window = load_le64(pixvals + (bitpos >> 3));
                value = (window >> (bitpos & 7)) & mask_val;
            }
            o[0] = idx / nx;
            o[1] = idx % nx;
            o[2] = value;
            o += 3;
            ++n_fg;
        }
    };

    uint64_t w = 0;
    for (; w < n_words; ++w) {
        const uint64_t word = load_le64(bitmap + w * 8);
        if (word) emit_range(word, w * 64);
    }
    // tail (< 64 pixels): assemble the remaining bytes
    const uint64_t tail_pixels = n_pixels - n_words * 64;
    if (tail_pixels) {
        uint64_t word = 0;
        const uint64_t tail_bytes = (tail_pixels + 7) / 8;
        for (uint64_t b = 0; b < tail_bytes; ++b)
            word |= (uint64_t)bitmap[n_words * 8 + b] << (8 * b);
        if (tail_pixels < 64) word &= (1ULL << tail_pixels) - 1;
        if (word) emit_range(word, n_words * 64);
    }
    return (int64_t)n_fg;
}

// Pack n u16 values into a bit_depth-bit LSB-first stream.
// out must hold ceil(n * bit_depth / 8) bytes (zero-fill not required).
void bit_pack_u16(const uint16_t *vals, uint64_t n, uint8_t bit_depth, uint8_t *out) {
    uint64_t reg = 0;   // shift register, LSB = next output bit
    uint32_t fill = 0;  // bits currently in the register
    uint8_t *p = out;
    const uint64_t vmask = (bit_depth >= 16) ? 0xFFFFULL : ((1ULL << bit_depth) - 1);
    for (uint64_t i = 0; i < n; ++i) {
        reg |= ((uint64_t)vals[i] & vmask) << fill;
        fill += bit_depth;
        while (fill >= 8) {
            *p++ = (uint8_t)reg;
            reg >>= 8;
            fill -= 8;
        }
    }
    if (fill) *p++ = (uint8_t)reg;
}

// Unpack n bit_depth-bit values from an LSB-first stream into u64s.
void bit_unpack_u64(const uint8_t *packed, uint64_t n, uint8_t bit_depth, uint64_t *out) {
    const uint64_t mask_val = bit_depth >= 64 ? ~0ULL : ((1ULL << bit_depth) - 1);
    for (uint64_t i = 0; i < n; ++i) {
        const uint64_t bitpos = i * bit_depth;
        const uint64_t window = load_le64(packed + (bitpos >> 3));
        out[i] = (window >> (bitpos & 7)) & mask_val;
    }
}

// 8-connected component labeling over a 0/1 byte mask (row-major).
// labels: ny*nx i32 out; 0 = background, components numbered 1..count in
// row-major first-encounter order (the semantics of scipy.ndimage.label with
// a full 3x3 structure, which the reference's L2/L4 writer path uses,
// recode_writer.py:443).  Two-pass union-find with path halving; serves the
// reader's L2 summary-stat decode (puddle count + order) natively, the role
// reader.h:39-41 plays for the reference's C decode path.
// Returns the component count.
int32_t label_components_u8(const uint8_t *mask, uint32_t ny, uint32_t nx,
                            int32_t *labels) {
    const uint64_t n = (uint64_t)ny * nx;
    std::vector<int32_t> parent(1, 0);
    auto find = [&](int32_t a) {
        while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
        return a;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a == b) return a;
        if (a > b) std::swap(a, b);
        parent[b] = a;
        return a;
    };
    for (uint32_t r = 0; r < ny; ++r) {
        for (uint32_t c = 0; c < nx; ++c) {
            const uint64_t i = (uint64_t)r * nx + c;
            if (!mask[i]) { labels[i] = 0; continue; }
            int32_t lab = 0;
            if (c && labels[i - 1]) lab = labels[i - 1];
            if (r) {
                const uint64_t up = i - nx;
                if (c && labels[up - 1])
                    lab = lab ? unite(lab, labels[up - 1]) : labels[up - 1];
                if (labels[up])
                    lab = lab ? unite(lab, labels[up]) : labels[up];
                if (c + 1 < nx && labels[up + 1])
                    lab = lab ? unite(lab, labels[up + 1]) : labels[up + 1];
            }
            if (!lab) {
                lab = (int32_t)parent.size();
                parent.push_back(lab);
            }
            labels[i] = lab;
        }
    }
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t count = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (!labels[i]) continue;
        const int32_t root = find(labels[i]);
        if (!remap[root]) remap[root] = ++count;
        labels[i] = remap[root];
    }
    return count;
}

// Pack a 0/1 byte mask into bits (LSB-first per byte).
void pack_mask(const uint8_t *mask, uint64_t n_pixels, uint8_t *out) {
    const uint64_t n_bytes = (n_pixels + 7) / 8;
    for (uint64_t b = 0; b < n_bytes; ++b) {
        uint8_t byte = 0;
        const uint64_t base = b * 8;
        const uint32_t lim = (uint32_t)((n_pixels - base) < 8 ? (n_pixels - base) : 8);
        for (uint32_t k = 0; k < lim; ++k)
            byte |= (mask[base + k] != 0) << k;
        out[b] = byte;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse deflate: a zlib-compatible encoder specialized for the codec's
// reduced streams (mostly-zero bitmaps, high-entropy packed residuals).
//
// Emits one fixed-Huffman deflate block (RFC 1951) wrapped in a zlib header
// + adler32 (RFC 1950): zero runs >= 4 become a literal '0' plus
// distance-1 matches (classic RLE-via-LZ77), everything else literals.
// Any inflate implementation decodes it; the reference reads these files
// unmodified.  Throughput is set by the nonzero-byte count, not the stream
// size, so sparse bitmaps encode at memory speed.
// ---------------------------------------------------------------------------

namespace {

// pre-reversed fixed-Huffman literal codes (code, nbits) for bytes 0..255
struct LitCode { uint16_t bits; uint8_t n; };
struct LitTable {
    LitCode t[256];
    LitTable() {
        for (int v = 0; v < 256; ++v) {
            uint32_t code, n;
            if (v < 144) { code = 0x30 + v; n = 8; }
            else { code = 0x190 + (v - 144); n = 9; }
            uint32_t rev = 0;
            for (uint32_t i = 0; i < n; ++i) rev |= ((code >> i) & 1u) << (n - 1 - i);
            t[v] = {(uint16_t)rev, (uint8_t)n};
        }
    }
};
static const LitTable kLit;

struct BitWriter {
    uint8_t *out;
    uint64_t acc = 0;
    uint32_t fill = 0;
    uint64_t pos = 0;

    explicit BitWriter(uint8_t *o) : out(o) {}

    inline void put_lsb(uint32_t bits, uint32_t n) {  // extra bits: LSB-first
        acc |= (uint64_t)bits << fill;
        fill += n;
        while (fill >= 8) {
            out[pos++] = (uint8_t)acc;
            acc >>= 8;
            fill -= 8;
        }
    }

    inline void put_huff(uint32_t code, uint32_t n) {  // Huffman: MSB-first
        uint32_t rev = 0;
        for (uint32_t i = 0; i < n; ++i) rev |= ((code >> i) & 1u) << (n - 1 - i);
        put_lsb(rev, n);
    }

    inline void byte_align() {
        if (fill) {
            out[pos++] = (uint8_t)acc;
            acc = 0;
            fill = 0;
        }
    }
};

inline void put_literal(BitWriter &bw, uint32_t v) {
    bw.put_lsb(kLit.t[v].bits, kLit.t[v].n);
}

// fixed-Huffman length code for match length 3..258: code 257..285
inline void put_length(BitWriter &bw, uint32_t len) {
    static const uint16_t base[] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19,
                                    23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115,
                                    131, 163, 195, 227, 258};
    static const uint8_t extra[] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                    2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    int c = 28;
    while (len < base[c]) --c;
    const uint32_t sym = 257 + c;
    if (sym < 280) bw.put_huff(sym - 256, 7);
    else bw.put_huff(0xC0 + (sym - 280), 8);
    if (extra[c]) bw.put_lsb(len - base[c], extra[c]);
}

inline void put_run(BitWriter &bw, uint32_t v, uint64_t run) {
    // literal v then distance-1 matches covering the remaining run-1 bytes
    put_literal(bw, v);
    uint64_t left = run - 1;
    while (left >= 3) {
        uint32_t take = left > 258 ? 258 : (uint32_t)left;
        if (left - take == 1 || left - take == 2) take -= 3;  // keep tail >= 3
        put_length(bw, take);
        bw.put_huff(0, 5);  // distance code 0 = 1, no extra bits
        left -= take;
    }
    while (left--) put_literal(bw, 0);
}

}  // namespace

extern "C" {

// Encode src[0..n) as a zlib stream into out (capacity must be
// >= n * 9 / 8 + 64 for the incompressible worst case).
// Returns the number of bytes written.
int64_t deflate_sparse(const uint8_t *src, uint64_t n, uint8_t *out) {
    BitWriter bw(out);
    out[bw.pos++] = 0x78;  // zlib: deflate, 32K window
    out[bw.pos++] = 0x01;  // fastest, no dict (FCHECK makes 0x7801 % 31 == 0)

    // estimate: ~8.1 bits/literal outside runs, ~21 bits per run; fall back
    // to stored blocks (raw copy) when RLE would exceed the input size
    uint64_t run_covered = 0, runs = 0;
    for (uint64_t i = 0; i < n;) {
        uint64_t j = i + 1;
        while (j < n && src[j] == src[i]) ++j;
        if (j - i >= 4) { run_covered += j - i; ++runs; }
        i = j;
    }
    const uint64_t est_bits = (n - run_covered) * 9 + runs * 30 + 64;

    if (est_bits / 8 >= n) {
        // stored blocks: 5-byte header per <=65535-byte chunk, raw payload
        uint64_t i = 0;
        do {
            const uint32_t take = (n - i) > 65535 ? 65535 : (uint32_t)(n - i);
            out[bw.pos++] = (i + take >= n) ? 1 : 0;  // BFINAL | BTYPE=00
            out[bw.pos++] = (uint8_t)take;
            out[bw.pos++] = (uint8_t)(take >> 8);
            out[bw.pos++] = (uint8_t)~take;
            out[bw.pos++] = (uint8_t)(~take >> 8);
            std::memcpy(out + bw.pos, src + i, take);
            bw.pos += take;
            i += take;
        } while (i < n);
    } else {
        bw.put_lsb(1, 1);      // BFINAL
        bw.put_lsb(1, 2);      // BTYPE = 01 (fixed Huffman), LSB-first
        uint64_t i = 0;
        while (i < n) {
            const uint8_t v = src[i];
            uint64_t j = i + 1;
            while (j < n && src[j] == v) ++j;
            const uint64_t run = j - i;
            if (run >= 4) put_run(bw, v, run);
            else for (uint64_t k = 0; k < run; ++k) put_literal(bw, v);
            i = j;
        }
        bw.put_huff(0, 7);  // end of block (symbol 256)
        bw.byte_align();
    }

    // adler32 of the uncompressed data, big-endian (RFC 1950)
    // incompressible data: redo as stored blocks (raw copy), strictly
    // bounded at n + 5 per 64K chunk + 6
    const uint64_t stored_size = 2 + n + 5 * (n / 65535 + 1);
    if (bw.pos > stored_size) {
        bw.pos = 2;
        bw.acc = 0;
        bw.fill = 0;
        uint64_t k = 0;
        do {
            const uint32_t take = (n - k) > 65535 ? 65535 : (uint32_t)(n - k);
            out[bw.pos++] = (k + take >= n) ? 1 : 0;
            out[bw.pos++] = (uint8_t)take;
            out[bw.pos++] = (uint8_t)(take >> 8);
            out[bw.pos++] = (uint8_t)~take;
            out[bw.pos++] = (uint8_t)(~take >> 8);
            std::memcpy(out + bw.pos, src + k, take);
            bw.pos += take;
            k += take;
        } while (k < n);
    }

    const uint32_t MOD = 65521;
    uint32_t a = 1, b = 0;
    for (uint64_t k = 0; k < n; ++k) {
        a += src[k];
        if (a >= MOD) a -= MOD;
        b += a;
        if (b >= MOD) b -= MOD;
    }
    const uint32_t adler = (b << 16) | a;
    out[bw.pos++] = (uint8_t)(adler >> 24);
    out[bw.pos++] = (uint8_t)(adler >> 16);
    out[bw.pos++] = (uint8_t)(adler >> 8);
    out[bw.pos++] = (uint8_t)adler;
    return (int64_t)bw.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Dynamic-Huffman variant: same zero/repeat-run tokenization, but with
// per-stream canonical Huffman codes and an RFC 1951 dynamic block header.
// Closes most of the ratio gap to zlib while keeping the single-pass-over-
// nonzeros speed profile.
// ---------------------------------------------------------------------------

namespace {

// canonical Huffman code lengths (<= limit) from symbol frequencies via
// boundary package-merge: optimal length-limited lengths in O(n * limit).
// (The previous heap merge flattened frequencies and rebuilt the whole tree
// until the depth fit, which on the skewed histograms of real bitmap streams
// cost ~100x more and produced sub-optimal lengths.)  Deterministic: leaves
// are ordered by (weight, symbol) and win ties against packages.
void huff_lengths(const uint32_t *freq, int n, int limit, uint8_t *len) {
    int live = 0;
    for (int i = 0; i < n; ++i) { len[i] = 0; if (freq[i]) ++live; }
    if (live == 0) return;
    if (live == 1) {
        for (int i = 0; i < n; ++i) if (freq[i]) len[i] = 1;
        return;
    }

    int order[320];
    int no = 0;
    for (int i = 0; i < n; ++i) if (freq[i]) order[no++] = i;
    std::sort(order, order + live, [&](int a, int b) {
        return freq[a] != freq[b] ? freq[a] < freq[b] : a < b; });

    // forward: build the merged (leaves + packages-of-previous-level) list
    // for each denomination level, keeping only weights and leaf flags; a
    // level never needs more than 2*live items because only the 2*(live-1)
    // cheapest are ever consumed
    const int cap = 2 * live;
    static thread_local std::vector<uint64_t> w;     // [level][item]
    static thread_local std::vector<uint8_t> isleaf;
    static thread_local std::vector<int> cnt;        // items per level
    // resize, not assign: every slot below cnt[level] is written before it
    // is read, so carrying stale bytes across calls is fine
    if (w.size() < (size_t)limit * cap) {
        w.resize((size_t)limit * cap);
        isleaf.resize((size_t)limit * cap);
    }
    if (cnt.size() < (size_t)limit) cnt.resize(limit);

    for (int k = 0; k < live; ++k) {
        w[k] = freq[order[k]];
        isleaf[k] = 1;
    }
    cnt[0] = live;
    for (int level = 1; level < limit; ++level) {
        const uint64_t *pw = &w[(size_t)(level - 1) * cap];
        uint64_t *cw = &w[(size_t)level * cap];
        uint8_t *cl = &isleaf[(size_t)level * cap];
        const int npkg = cnt[level - 1] / 2;
        int i = 0, j = 0, m = 0;
        while (m < cap && (i < live || j < npkg)) {
            const uint64_t pkw = (j < npkg)
                ? pw[2 * j] + pw[2 * j + 1] : UINT64_MAX;
            if (i < live && (uint64_t)freq[order[i]] <= pkw) {
                cw[m] = freq[order[i]];
                cl[m] = 1;
                ++i;
            } else {
                cw[m] = pkw;
                cl[m] = 0;
                ++j;
            }
            ++m;
        }
        cnt[level] = m;
    }

    // backward: consume the 2*(live-1) cheapest items of the final level;
    // at each level the c leaf-items among the first t are necessarily the
    // c cheapest leaves overall (same sorted list at every level), so each
    // adds one bit to the lengths of order[0..c); packages expand to the
    // first 2*(t - c) items of the level below
    int t = 2 * (live - 1);
    for (int level = limit - 1; level >= 0 && t > 0; --level) {
        const uint8_t *cl = &isleaf[(size_t)level * cap];
        int c = 0;
        for (int m = 0; m < t; ++m) c += cl[m];
        for (int k = 0; k < c; ++k) ++len[order[k]];
        t = 2 * (t - c);
    }
}

// canonical codes from lengths (RFC 1951 3.2.2)
void huff_codes(const uint8_t *len, int n, uint16_t *code) {
    uint32_t bl_count[16] = {0};
    for (int i = 0; i < n; ++i) ++bl_count[len[i]];
    bl_count[0] = 0;
    uint32_t next[16], c = 0;
    for (int bits = 1; bits <= 15; ++bits) {
        c = (c + bl_count[bits - 1]) << 1;
        next[bits] = c;
    }
    for (int i = 0; i < n; ++i)
        code[i] = len[i] ? (uint16_t)next[len[i]]++ : 0;
}

// length symbol + extra bits for match length 3..258
inline void length_symbol(uint32_t len, uint32_t &sym, uint32_t &extra_bits,
                          uint32_t &extra_val) {
    static const uint16_t base[] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19,
                                    23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115,
                                    131, 163, 195, 227, 258};
    static const uint8_t extra[] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                    2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    int c = 28;
    while (len < base[c]) --c;
    sym = 257 + c;
    extra_bits = extra[c];
    extra_val = len - base[c];
}

// Serialize the RFC 1951 dynamic block header (HLIT/HDIST/HCLEN + code-length
// code + length sequence) for literal/length lengths `llen` and the codec's
// fixed single-distance-code table.  Factored out so the numpy reference
// encoder (codecs/dyndeflate.py) obtains a bit-identical header.
void write_dyn_header(BitWriter &bw, const uint8_t *llen) {
    uint8_t dlen[30] = {0};
    dlen[0] = 1;

    bw.put_lsb(1, 1);  // BFINAL
    bw.put_lsb(2, 2);  // BTYPE = 10 (dynamic)

    int hlit = 286;
    while (hlit > 257 && llen[hlit - 1] == 0) --hlit;
    int hdist = 1;  // just distance code 0
    uint8_t all_len[286 + 30];
    for (int k = 0; k < hlit; ++k) all_len[k] = llen[k];
    for (int k = 0; k < hdist; ++k) all_len[hlit + k] = dlen[k];
    const int all_n = hlit + hdist;

    // encode the length sequence with symbols 0-18 (16=repeat prev,
    // 17/18 = zero runs)
    uint32_t clfreq[19] = {0};
    uint32_t clsyms[286 + 30 + 8];
    uint32_t clextra[286 + 30 + 8];
    uint32_t clebits[286 + 30 + 8];
    int ncl = 0;
    for (int k = 0; k < all_n;) {
        const uint8_t v = all_len[k];
        int j2 = k + 1;
        while (j2 < all_n && all_len[j2] == v) ++j2;
        int run = j2 - k;
        if (v == 0) {
            while (run >= 11) {
                int take = run > 138 ? 138 : run;
                clsyms[ncl] = 18; clextra[ncl] = take - 11; clebits[ncl] = 7; ++ncl; ++clfreq[18];
                run -= take;
            }
            while (run >= 3) {
                int take = run > 10 ? 10 : run;
                clsyms[ncl] = 17; clextra[ncl] = take - 3; clebits[ncl] = 3; ++ncl; ++clfreq[17];
                run -= take;
            }
            while (run--) { clsyms[ncl] = 0; clebits[ncl] = 0; ++ncl; ++clfreq[0]; }
        } else {
            clsyms[ncl] = v; clebits[ncl] = 0; ++ncl; ++clfreq[v];
            --run;
            while (run >= 3) {
                int take = run > 6 ? 6 : run;
                clsyms[ncl] = 16; clextra[ncl] = take - 3; clebits[ncl] = 2; ++ncl; ++clfreq[16];
                run -= take;
            }
            while (run--) { clsyms[ncl] = v; clebits[ncl] = 0; ++ncl; ++clfreq[v]; }
        }
        k = j2;
    }
    uint8_t cllen[19];
    uint16_t clcode[19];
    huff_lengths(clfreq, 19, 7, cllen);
    huff_codes(cllen, 19, clcode);

    static const uint8_t clorder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4,
                                        12, 3, 13, 2, 14, 1, 15};
    int hclen = 19;
    while (hclen > 4 && cllen[clorder[hclen - 1]] == 0) --hclen;

    bw.put_lsb(hlit - 257, 5);
    bw.put_lsb(hdist - 1, 5);
    bw.put_lsb(hclen - 4, 4);
    for (int k = 0; k < hclen; ++k) bw.put_lsb(cllen[clorder[k]], 3);
    for (int k = 0; k < ncl; ++k) {
        bw.put_huff(clcode[clsyms[k]], cllen[clsyms[k]]);
        if (clebits[k]) bw.put_lsb(clextra[k], clebits[k]);
    }
}

}  // namespace

extern "C" {

// Build canonical dynamic-Huffman tables from 286 literal/length frequencies.
// (Exported so the numpy reference encoder shares this exact construction —
// tie-breaking included — making its streams byte-identical to
// deflate_sparse_dyn's.)
void dyn_tables(const uint32_t *lfreq, uint8_t *llen, uint16_t *lcode) {
    huff_lengths(lfreq, 286, 15, llen);
    huff_codes(llen, 286, lcode);
}

// Serialize zlib header (2 bytes) + BFINAL/BTYPE + dynamic block header into
// out (capacity >= 400 bytes; the trailing partial byte is written zero-padded).
// Returns the total BIT length including the 16 zlib-header bits.
int64_t dyn_header(const uint8_t *llen, uint8_t *out) {
    BitWriter bw(out);
    out[bw.pos++] = 0x78;
    out[bw.pos++] = 0x01;
    write_dyn_header(bw, llen);
    const int64_t bits = (int64_t)bw.pos * 8 + bw.fill;
    if (bw.fill) out[bw.pos] = (uint8_t)bw.acc;  // partial byte, zero-padded
    return bits;
}

// Dynamic-Huffman sparse deflate (zlib stream).  out capacity as for
// deflate_sparse.  Scratch token buffer must hold n+16 uint32.
int64_t deflate_sparse_dyn(const uint8_t *src, uint64_t n, uint8_t *out,
                           uint32_t *tokens) {
    // ---- tokenize: literal v, or run -> literal v + matches (dist 1) ----
    uint64_t ntok = 0;
    uint32_t lfreq[286] = {0};
    uint64_t i = 0;
    while (i < n) {
        const uint8_t v = src[i];
        uint64_t j = i + 1;
        while (j < n && src[j] == v) ++j;
        uint64_t run = j - i;
        if (run >= 4) {
            tokens[ntok++] = v;  // literal
            ++lfreq[v];
            uint64_t left = run - 1;
            while (left >= 3) {
                uint32_t take = left > 258 ? 258 : (uint32_t)left;
                if (left - take == 1 || left - take == 2) take -= 3;
                tokens[ntok++] = 0x80000000u | take;
                uint32_t sym, eb, ev;
                length_symbol(take, sym, eb, ev);
                ++lfreq[sym];
                left -= take;
            }
            while (left--) { tokens[ntok++] = v; ++lfreq[v]; }
        } else {
            while (run--) { tokens[ntok++] = v; ++lfreq[v]; }
        }
        i = j;
    }
    ++lfreq[256];  // end of block

    // ---- literal/length + distance code construction ----
    uint8_t llen[286];
    uint16_t lcode[286];
    huff_lengths(lfreq, 286, 15, llen);
    huff_codes(llen, 286, lcode);
    // single distance symbol (0 = distance 1): dlen[0]=1, dcode[0]=0
    const uint8_t dlen0 = 1;
    const uint16_t dcode0 = 0;

    BitWriter bw(out);
    out[bw.pos++] = 0x78;
    out[bw.pos++] = 0x01;
    write_dyn_header(bw, llen);

    // ---- emit tokens ----
    for (uint64_t k = 0; k < ntok; ++k) {
        const uint32_t tok = tokens[k];
        if (tok & 0x80000000u) {
            uint32_t sym, eb, ev;
            length_symbol(tok & 0x7FFFFFFFu, sym, eb, ev);
            bw.put_huff(lcode[sym], llen[sym]);
            if (eb) bw.put_lsb(ev, eb);
            bw.put_huff(dcode0, dlen0);  // distance 1
        } else {
            bw.put_huff(lcode[tok], llen[tok]);
        }
    }
    bw.put_huff(lcode[256], llen[256]);
    bw.byte_align();

    // incompressible data: redo as stored blocks (raw copy), strictly
    // bounded at n + 5 per 64K chunk + 6
    const uint64_t stored_size = 2 + n + 5 * (n / 65535 + 1);
    if (bw.pos > stored_size) {
        bw.pos = 2;
        bw.acc = 0;
        bw.fill = 0;
        uint64_t k = 0;
        do {
            const uint32_t take = (n - k) > 65535 ? 65535 : (uint32_t)(n - k);
            out[bw.pos++] = (k + take >= n) ? 1 : 0;
            out[bw.pos++] = (uint8_t)take;
            out[bw.pos++] = (uint8_t)(take >> 8);
            out[bw.pos++] = (uint8_t)~take;
            out[bw.pos++] = (uint8_t)(~take >> 8);
            std::memcpy(out + bw.pos, src + k, take);
            bw.pos += take;
            k += take;
        } while (k < n);
    }

    const uint32_t MOD = 65521;
    uint32_t a = 1, b = 0;
    for (uint64_t k = 0; k < n; ++k) {
        a += src[k];
        if (a >= MOD) a -= MOD;
        b += a;
        if (b >= MOD) b -= MOD;
    }
    const uint32_t adler = (b << 16) | a;
    out[bw.pos++] = (uint8_t)(adler >> 24);
    out[bw.pos++] = (uint8_t)(adler >> 16);
    out[bw.pos++] = (uint8_t)(adler >> 8);
    out[bw.pos++] = (uint8_t)adler;
    return (int64_t)bw.pos;
}

}  // extern "C"

// ===================== rANS host codec (scheme 12) =====================
// Byte-for-byte the format of codecs/rans.py (the numpy reference): the
// same LZ run tokenizer as deflate_sparse_dyn, 12-bit quantized order-0
// frequencies, W interleaved rANS states (byte renormalization,
// x in [2^23, 2^31)), body stored in EMIT order (decoder walks backward).

static const uint32_t RANS_L12 = 1u << 23;
static const uint32_t RANS_M12 = 1u << 12;
static const int RANS_NSYM = 286;

static const uint16_t RANS_LEN_BASE[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
    51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t RANS_LEN_EXTRA[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 4, 5, 5, 5, 5, 0};

// quantize counts to sum exactly 4096; mirrors codecs/rans.quantize_freqs
// (largest-remainder in float64 with stable index tie-break, then steal
// from the first maximum) so host and numpy encoders are byte-identical.
static void rans_quantize(const uint64_t *counts, uint16_t *q) {
    uint64_t n = 0;
    for (int s = 0; s < RANS_NSYM; ++s) n += counts[s];
    if (n == 0) {
        for (int s = 0; s < RANS_NSYM; ++s) q[s] = 0;
        q[0] = (uint16_t)RANS_M12;
        return;
    }
    double rema[RANS_NSYM];
    int64_t qi[RANS_NSYM];
    int64_t sum = 0;
    for (int s = 0; s < RANS_NSYM; ++s) {
        const double ideal = (double)counts[s] * (double)RANS_M12 / (double)n;
        int64_t v = (int64_t)ideal;  // floor for non-negative
        rema[s] = ideal - (double)v;
        if (counts[s] > 0 && v == 0) v = 1;
        if (counts[s] == 0) rema[s] = -1.0;
        qi[s] = v;
        sum += v;
    }
    int64_t diff = (int64_t)RANS_M12 - sum;
    if (diff > 0) {
        int order[RANS_NSYM];
        for (int s = 0; s < RANS_NSYM; ++s) order[s] = s;
        std::sort(order, order + RANS_NSYM, [&](int a, int b) {
            return rema[a] != rema[b] ? rema[a] > rema[b] : a < b; });
        for (int k = 0; k < diff; ++k) ++qi[order[k]];
    } else {
        for (int64_t k = 0; k < -diff; ++k) {
            int best = 0;
            int64_t bv = -1;
            for (int s = 0; s < RANS_NSYM; ++s) {
                const int64_t cand = qi[s] > 1 ? qi[s] : -1;
                if (cand > bv) { bv = cand; best = s; }
            }
            --qi[best];
        }
    }
    for (int s = 0; s < RANS_NSYM; ++s) q[s] = (uint16_t)qi[s];
}

static void rans_adler(const uint8_t *src, uint64_t n, uint8_t *out4) {
    const uint32_t MOD = 65521;
    uint32_t a = 1, b = 0;
    for (uint64_t k = 0; k < n; ++k) {
        a += src[k];
        if (a >= MOD) a -= MOD;
        b += a;
        if (b >= MOD) b -= MOD;
    }
    const uint32_t adler = (b << 16) | a;
    out4[0] = (uint8_t)(adler >> 24);
    out4[1] = (uint8_t)(adler >> 16);
    out4[2] = (uint8_t)(adler >> 8);
    out4[3] = (uint8_t)adler;
}

extern "C" {

// rANS compress.  tokens: scratch of n+16 u32 (sym | ev<<10 | eb<<15).
// out capacity >= n + 64 + 4*nways + 2*286.  Returns stream length.
int64_t rans_compress(const uint8_t *src, uint64_t n, uint8_t *out,
                      uint32_t *tokens, uint32_t nways) {
    // ---- tokenize (identical run structure to deflate_sparse_dyn) ----
    uint64_t ntok = 0;
    uint64_t counts[RANS_NSYM] = {0};
    uint64_t i = 0;
    while (i < n) {
        const uint8_t v = src[i];
        uint64_t j = i + 1;
        while (j < n && src[j] == v) ++j;
        uint64_t run = j - i;
        if (run >= 4) {
            tokens[ntok++] = v;
            ++counts[v];
            uint64_t left = run - 1;
            while (left >= 3) {
                uint32_t take = left > 258 ? 258 : (uint32_t)left;
                if (left - take == 1 || left - take == 2) take -= 3;
                uint32_t sym, eb, ev;
                length_symbol(take, sym, eb, ev);
                tokens[ntok++] = sym | (ev << 10) | (eb << 15);
                ++counts[sym];
                left -= take;
            }
            while (left--) { tokens[ntok++] = v; ++counts[v]; }
        } else {
            while (run--) { tokens[ntok++] = v; ++counts[v]; }
        }
        i = j;
    }
    while (nways > 8 && nways > ntok) nways >>= 1;
    uint32_t lg = 0;
    while ((1u << lg) < nways) ++lg;

    uint16_t freq[RANS_NSYM];
    rans_quantize(counts, freq);
    uint32_t cum[RANS_NSYM + 1] = {0};
    for (int s = 0; s < RANS_NSYM; ++s) cum[s + 1] = cum[s] + freq[s];

    // ---- header ----
    uint64_t p = 0;
    out[p++] = 0xA5;
    out[p++] = 1;
    out[p++] = (uint8_t)lg;
    out[p++] = 0;
    auto put32 = [&](uint64_t v) {
        out[p++] = (uint8_t)v; out[p++] = (uint8_t)(v >> 8);
        out[p++] = (uint8_t)(v >> 16); out[p++] = (uint8_t)(v >> 24);
    };
    put32(n);
    put32(ntok);
    const uint64_t body_len_pos = p;
    put32(0);                       // body_bytes, patched below
    const uint64_t xbits_len_pos = p;
    put32(0);                       // xbits_bytes, patched below
    uint8_t used_bm[(RANS_NSYM + 7) / 8] = {0};
    for (int s = 0; s < RANS_NSYM; ++s)
        if (freq[s]) used_bm[s >> 3] |= (uint8_t)(1u << (s & 7));
    std::memcpy(out + p, used_bm, sizeof(used_bm));
    p += sizeof(used_bm);
    for (int s = 0; s < RANS_NSYM; ++s)
        if (freq[s]) { out[p++] = (uint8_t)freq[s];
                       out[p++] = (uint8_t)(freq[s] >> 8); }
    const uint64_t states_pos = p;
    p += 4ull * nways;

    // ---- per-symbol reciprocal tables: the encode becomes divide-free
    // (alias of the classic rANS encoder symbol precomputation; exactly
    // reproduces (x/f << 12) + x%f + cum, verified by the byte-identity
    // fuzz against the numpy reference) ----
    uint32_t rcp[RANS_NSYM], bias[RANS_NSYM], cmpl[RANS_NSYM];
    uint32_t rshift[RANS_NSYM], xmaxs[RANS_NSYM];
    for (int sidx = 0; sidx < RANS_NSYM; ++sidx) {
        const uint32_t f = freq[sidx];
        if (!f) continue;
        xmaxs[sidx] = f << 19;
        if (f < 2) {
            rcp[sidx] = ~0u;
            rshift[sidx] = 0;
            bias[sidx] = cum[sidx] + RANS_M12 - 1;
            cmpl[sidx] = RANS_M12 - 1;
        } else {
            uint32_t sh = 0;
            while (f > (1u << sh)) ++sh;
            rcp[sidx] = (uint32_t)(((1ull << (sh + 31)) + f - 1) / f);
            rshift[sidx] = sh - 1;
            bias[sidx] = cum[sidx];
            cmpl[sidx] = ((uint32_t)1 << 12) - f;
        }
    }

    // ---- interleaved rANS encode: token order (row desc, lane desc)
    // within rows of nways == plain descending token index ----
    static thread_local std::vector<uint32_t> xs;
    xs.assign(nways, RANS_L12);
    const uint64_t body_pos = p;
    for (uint64_t k = ntok; k-- > 0;) {
        const uint32_t lane = (uint32_t)(k & (nways - 1));
        const uint32_t sym = tokens[k] & 1023;
        uint32_t x = xs[lane];
        const uint32_t xmax = xmaxs[sym];
        while (x >= xmax) { out[p++] = (uint8_t)x; x >>= 8; }
        const uint32_t q =
            (uint32_t)(((uint64_t)x * rcp[sym]) >> 32) >> rshift[sym];
        xs[lane] = x + bias[sym] + (q << 12) - q * (uint32_t)freq[sym];
    }
    const uint64_t body_bytes = p - body_pos;
    for (uint32_t w = 0; w < nways; ++w) {
        out[states_pos + 4 * w] = (uint8_t)xs[w];
        out[states_pos + 4 * w + 1] = (uint8_t)(xs[w] >> 8);
        out[states_pos + 4 * w + 2] = (uint8_t)(xs[w] >> 16);
        out[states_pos + 4 * w + 3] = (uint8_t)(xs[w] >> 24);
    }

    // ---- extra bits, LSB-first in token order ----
    const uint64_t xb_pos = p;
    uint32_t acc = 0;
    int fill = 0;
    for (uint64_t k = 0; k < ntok; ++k) {
        const uint32_t eb = tokens[k] >> 15;
        if (!eb) continue;
        acc |= ((tokens[k] >> 10) & 31) << fill;
        fill += (int)eb;
        while (fill >= 8) { out[p++] = (uint8_t)acc; acc >>= 8; fill -= 8; }
    }
    if (fill) out[p++] = (uint8_t)acc;
    const uint64_t xbits_bytes = p - xb_pos;

    auto patch32 = [&](uint64_t pos, uint64_t v) {
        out[pos] = (uint8_t)v; out[pos + 1] = (uint8_t)(v >> 8);
        out[pos + 2] = (uint8_t)(v >> 16); out[pos + 3] = (uint8_t)(v >> 24);
    };
    patch32(body_len_pos, body_bytes);
    patch32(xbits_len_pos, xbits_bytes);
    rans_adler(src, n, out + p);
    p += 4;

    if (p > n + 24) {               // stored stream = n + 24 B; coded must
                                    // be strictly smaller (matches rans.py)
        p = 0;
        out[p++] = 0xA5; out[p++] = 1; out[p++] = 0; out[p++] = 1;
        put32(n); put32(0); put32(n); put32(0);
        std::memmove(out + p, src, n);
        p += n;
        rans_adler(src, n, out + p);
        p += 4;
    }
    return (int64_t)p;
}

// rANS decompress.  Returns original length, or -1 on corruption /
// capacity overflow.
int64_t rans_decompress(const uint8_t *src, uint64_t len, uint8_t *out,
                        uint64_t cap) {
    // Every header-derived length is validated against the buffer BEFORE
    // use: the reader feeds raw file bytes here, so corrupt or hostile
    // input must fail with -1, never read out of bounds.
    if (len < 20 || src[0] != 0xA5 || src[1] != 1) return -1;
    if (src[2] > 16) return -1;           // lane count (1u << 32 is UB)
    const uint32_t nways = 1u << src[2];
    const uint32_t flags = src[3];
    auto get32 = [&](uint64_t pos) {
        return (uint64_t)src[pos] | ((uint64_t)src[pos + 1] << 8) |
               ((uint64_t)src[pos + 2] << 16) | ((uint64_t)src[pos + 3] << 24);
    };
    const uint32_t MOD = 65521;
    auto adler_of = [&](const uint8_t *buf, uint64_t nn) {
        uint32_t a = 1, b = 0;
        for (uint64_t k = 0; k < nn; ++k) {
            a += buf[k];
            if (a >= MOD) a -= MOD;
            b += a;
            if (b >= MOD) b -= MOD;
        }
        return (b << 16) | a;
    };
    const uint64_t n = get32(4);
    const uint64_t m = get32(8);
    const uint64_t body_bytes = get32(12);
    const uint64_t xbits_bytes = get32(16);
    uint64_t p = 20;
    if (n > cap) return -1;
    if (flags & 1) {
        if (p + n + 4 > len) return -1;
        std::memcpy(out, src + p, n);
        const uint32_t want = ((uint32_t)src[p + n] << 24) |
                              ((uint32_t)src[p + n + 1] << 16) |
                              ((uint32_t)src[p + n + 2] << 8) |
                              (uint32_t)src[p + n + 3];
        return adler_of(out, n) == want ? (int64_t)n : -1;
    }
    if (p + (RANS_NSYM + 7) / 8 > len) return -1;
    uint16_t freq[RANS_NSYM] = {0};
    const uint8_t *bm = src + p;
    p += (RANS_NSYM + 7) / 8;
    uint32_t n_used = 0;
    for (int s = 0; s < RANS_NSYM; ++s)
        if (bm[s >> 3] & (1u << (s & 7))) ++n_used;
    if (p + 2ull * n_used + 4ull * nways + body_bytes + xbits_bytes + 4 > len)
        return -1;
    for (int s = 0; s < RANS_NSYM; ++s)
        if (bm[s >> 3] & (1u << (s & 7))) {
            freq[s] = (uint16_t)(src[p] | (src[p + 1] << 8));
            p += 2;
        }
    uint32_t cum[RANS_NSYM + 1] = {0};
    for (int s = 0; s < RANS_NSYM; ++s) cum[s + 1] = cum[s] + freq[s];
    if (cum[RANS_NSYM] != RANS_M12) return -1;
    static thread_local std::vector<uint16_t> slot2sym;
    slot2sym.resize(RANS_M12);
    for (int s = 0; s < RANS_NSYM; ++s)
        for (uint32_t t = cum[s]; t < cum[s + 1]; ++t)
            slot2sym[t] = (uint16_t)s;

    static thread_local std::vector<uint32_t> xs;
    xs.resize(nways);
    for (uint32_t w = 0; w < nways; ++w)
        xs[w] = (uint32_t)get32(p + 4ull * w);
    p += 4ull * nways;
    const uint8_t *body = src + p;
    p += body_bytes;
    const uint8_t *xbits = src + p;
    p += xbits_bytes;
    if (p + 4 > len) return -1;

    int64_t bpos = (int64_t)body_bytes - 1;   // emit order: read backward
    uint64_t xb_bit = 0;
    uint64_t o = 0;
    for (uint64_t k = 0; k < m; ++k) {
        const uint32_t lane = (uint32_t)(k & (nways - 1));
        uint32_t x = xs[lane];
        const uint32_t slot = x & (RANS_M12 - 1);
        const uint32_t sym = slot2sym[slot];
        x = freq[sym] * (x >> 12) + slot - cum[sym];
        while (x < RANS_L12) {
            if (bpos < 0) return -1;
            x = (x << 8) | body[bpos--];
        }
        xs[lane] = x;
        if (sym < 256) {
            if (o >= n) return -1;
            out[o++] = (uint8_t)sym;
        } else {
            const uint32_t c = sym - 257;
            if (c >= 29) return -1;
            uint32_t take = RANS_LEN_BASE[c];
            const uint32_t eb = RANS_LEN_EXTRA[c];
            if (eb) {
                if ((xb_bit + eb + 7) / 8 > xbits_bytes) return -1;
                uint32_t ev = 0;
                for (uint32_t b = 0; b < eb; ++b, ++xb_bit)
                    ev |= (uint32_t)((xbits[xb_bit >> 3] >> (xb_bit & 7)) & 1)
                          << b;
                take += ev;
            }
            if (o == 0 || o + take > n) return -1;
            std::memset(out + o, out[o - 1], take);
            o += take;
        }
    }
    if (o != (uint64_t)n) return -1;
    const uint32_t want = ((uint32_t)src[p] << 24) |
                          ((uint32_t)src[p + 1] << 16) |
                          ((uint32_t)src[p + 2] << 8) | (uint32_t)src[p + 3];
    return adler_of(out, n) == want ? (int64_t)n : -1;
}

// Reconstruct the byte stream from an ALREADY-DECODED symbol array + the
// extra-bit stream: literals emit their byte, matches memset-copy the
// previous byte (all distance 1).  Memcpy-class, so the numpy decoder
// (codecs/rans._reconstruct_bytes) is not bottlenecked by per-token passes.
// Returns n on success, -1 on malformed input (bounds are validated the
// same way as rans_decompress above; the adler check stays in Python).
int64_t rans_reconstruct(const int32_t *syms, uint64_t m,
                         const uint8_t *xbits, uint64_t xbits_bytes,
                         uint8_t *out, uint64_t n) {
    uint64_t xb_bit = 0, o = 0;
    for (uint64_t k = 0; k < m; ++k) {
        const int32_t sv = syms[k];
        if (sv < 0 || sv >= RANS_NSYM || sv == 256) return -1;
        if (sv < 256) {
            if (o >= n) return -1;
            out[o++] = (uint8_t)sv;
        } else {
            const uint32_t c = (uint32_t)sv - 257;
            if (c >= 29) return -1;
            uint32_t take = RANS_LEN_BASE[c];
            const uint32_t eb = RANS_LEN_EXTRA[c];
            if (eb) {
                if ((xb_bit + eb + 7) / 8 > xbits_bytes) return -1;
                uint32_t ev = 0;
                for (uint32_t b = 0; b < eb; ++b, ++xb_bit)
                    ev |= (uint32_t)((xbits[xb_bit >> 3] >> (xb_bit & 7)) & 1)
                          << b;
                take += ev;
            }
            if (o == 0 || o + take > n) return -1;
            std::memset(out + o, out[o - 1], take);
            o += take;
        }
    }
    return o == (uint64_t)n ? (int64_t)o : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS SYMBOL mode (flags bit1): the payload is an LSB-first packed
// stream of sym_bits-wide values coded DIRECTLY as symbols over a sparse
// 12-bit-quantized frequency table — no LZ layer, no extra bits.  Format and
// byte order exactly mirror codecs/rans.compress_symbols (the numpy
// reference); parity is enforced by tests/test_native.py.

// generalized quantizer over an arbitrary alphabet size (heap-allocated;
// alphabet <= 65536)
static void rans_quantize_n(const uint64_t *counts, uint16_t *q, int A) {
    uint64_t n = 0;
    for (int s = 0; s < A; ++s) n += counts[s];
    if (n == 0) {
        for (int s = 0; s < A; ++s) q[s] = 0;
        q[0] = (uint16_t)RANS_M12;
        return;
    }
    std::vector<double> rema(A);
    std::vector<int64_t> qi(A);
    int64_t sum = 0;
    for (int s = 0; s < A; ++s) {
        const double ideal = (double)counts[s] * (double)RANS_M12 / (double)n;
        int64_t v = (int64_t)ideal;
        rema[s] = ideal - (double)v;
        if (counts[s] > 0 && v == 0) v = 1;
        if (counts[s] == 0) rema[s] = -1.0;
        qi[s] = v;
        sum += v;
    }
    int64_t diff = (int64_t)RANS_M12 - sum;
    if (diff > 0) {
        std::vector<int> order(A);
        for (int s = 0; s < A; ++s) order[s] = s;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return rema[a] != rema[b] ? rema[a] > rema[b] : a < b; });
        for (int64_t k = 0; k < diff; ++k) ++qi[order[k]];
    } else {
        for (int64_t k = 0; k < -diff; ++k) {
            int best = 0;
            int64_t bv = -1;
            for (int s = 0; s < A; ++s) {
                const int64_t cand = qi[s] > 1 ? qi[s] : -1;
                if (cand > bv) { bv = cand; best = s; }
            }
            --qi[best];
        }
    }
    for (int s = 0; s < A; ++s) q[s] = (uint16_t)qi[s];
}

// Shared symbol/gap-mode encode core: histogram -> quantize -> header
// (flags byte as given) -> rANS body -> adler over adler_src[0..n).
// Returns the stream length, or -1 when the alphabet cannot be coded
// (> 4096 distinct symbols).  Byte layout mirrors
// codecs/rans._finish_stream_symbols exactly.
static int64_t rans_encode_vals_stream(const uint32_t *vals, uint64_t m,
                                       const uint8_t *adler_src, uint64_t n,
                                       uint32_t sym_bits, uint8_t flags,
                                       uint32_t nways, uint8_t *out) {
    const int A = 1 << sym_bits;
    std::vector<uint64_t> counts(A, 0);
    for (uint64_t k = 0; k < m; ++k) ++counts[vals[k]];
    uint32_t n_used = 0;
    for (int s = 0; s < A; ++s) n_used += counts[s] != 0;
    if (n_used > RANS_M12) return -1;

    std::vector<uint16_t> freq(A);
    rans_quantize_n(counts.data(), freq.data(), A);
    std::vector<uint32_t> cum(A + 1, 0);
    for (int s = 0; s < A; ++s) cum[s + 1] = cum[s] + freq[s];

    uint32_t lg = 0;
    while ((1u << lg) < nways) ++lg;

    uint64_t p = 0;
    out[p++] = 0xA5;
    out[p++] = 1;
    out[p++] = (uint8_t)lg;
    out[p++] = flags;
    auto put32 = [&](uint64_t v) {
        out[p++] = (uint8_t)v; out[p++] = (uint8_t)(v >> 8);
        out[p++] = (uint8_t)(v >> 16); out[p++] = (uint8_t)(v >> 24);
    };
    put32(n);
    put32(m);
    const uint64_t body_len_pos = p;
    put32(0);
    put32(0);                       // xbits_bytes = 0
    out[p++] = (uint8_t)sym_bits;
    out[p++] = 0;
    uint32_t used_cnt = 0;
    for (int s = 0; s < A; ++s) used_cnt += freq[s] != 0;
    out[p++] = (uint8_t)used_cnt;
    out[p++] = (uint8_t)(used_cnt >> 8);
    for (int s = 0; s < A; ++s)
        if (freq[s]) { out[p++] = (uint8_t)s; out[p++] = (uint8_t)(s >> 8); }
    for (int s = 0; s < A; ++s)
        if (freq[s]) { out[p++] = (uint8_t)freq[s];
                       out[p++] = (uint8_t)(freq[s] >> 8); }
    const uint64_t states_pos = p;
    p += 4ull * nways;

    // divide-free per-symbol reciprocals (sparse: only used symbols)
    std::vector<uint32_t> rcp(A), bias(A), rshift(A), xmaxs(A);
    for (int sidx = 0; sidx < A; ++sidx) {
        const uint32_t f = freq[sidx];
        if (!f) continue;
        xmaxs[sidx] = f << 19;
        if (f < 2) {
            rcp[sidx] = ~0u;
            rshift[sidx] = 0;
            bias[sidx] = cum[sidx] + RANS_M12 - 1;
        } else {
            uint32_t sh = 0;
            while (f > (1u << sh)) ++sh;
            rcp[sidx] = (uint32_t)(((1ull << (sh + 31)) + f - 1) / f);
            rshift[sidx] = sh - 1;
            bias[sidx] = cum[sidx];
        }
    }

    static thread_local std::vector<uint32_t> xs;
    xs.assign(nways, RANS_L12);
    const uint64_t body_pos = p;
    for (uint64_t k = m; k-- > 0;) {
        const uint32_t lane = (uint32_t)(k & (nways - 1));
        const uint32_t sym = vals[k];
        uint32_t x = xs[lane];
        const uint32_t xmax = xmaxs[sym];
        while (x >= xmax) { out[p++] = (uint8_t)x; x >>= 8; }
        const uint32_t q =
            (uint32_t)(((uint64_t)x * rcp[sym]) >> 32) >> rshift[sym];
        xs[lane] = x + bias[sym] + (q << 12) - q * (uint32_t)freq[sym];
    }
    const uint64_t body_bytes = p - body_pos;
    for (uint32_t w = 0; w < nways; ++w) {
        out[states_pos + 4 * w] = (uint8_t)xs[w];
        out[states_pos + 4 * w + 1] = (uint8_t)(xs[w] >> 8);
        out[states_pos + 4 * w + 2] = (uint8_t)(xs[w] >> 16);
        out[states_pos + 4 * w + 3] = (uint8_t)(xs[w] >> 24);
    }
    out[body_len_pos] = (uint8_t)body_bytes;
    out[body_len_pos + 1] = (uint8_t)(body_bytes >> 8);
    out[body_len_pos + 2] = (uint8_t)(body_bytes >> 16);
    out[body_len_pos + 3] = (uint8_t)(body_bytes >> 24);
    rans_adler(adler_src, n, out + p);
    p += 4;
    return (int64_t)p;
}

extern "C" {

// Symbol-mode encode of a packed value stream.  nways is the FINAL lane
// count (the caller applies the adaptive rule).  Returns the coded stream
// length (never the stored/byte fallback — the caller compares), or -1 when
// symbol coding is inapplicable (trailing pad bits nonzero, or more than
// 4096 distinct symbols).  out capacity >= 2*n + 64 + 4*nways + 4*4096.
int64_t rans_compress_symbols(const uint8_t *src, uint64_t n,
                              uint32_t sym_bits, uint32_t nways,
                              uint8_t *out) {
    if (sym_bits < 8 || sym_bits > 16 || nways < 8 ||
        (nways & (nways - 1)) != 0)
        return -1;
    const uint64_t m = n * 8 / sym_bits;
    const int A = 1 << sym_bits;

    // unpack + histogram; then verify the repack reproduces src exactly
    static thread_local std::vector<uint32_t> vals;
    vals.resize(m);
    {
        uint64_t bit = 0;
        for (uint64_t k = 0; k < m; ++k, bit += sym_bits) {
            const uint64_t byte = bit >> 3;
            const uint32_t sh = (uint32_t)(bit & 7);
            uint32_t v = (uint32_t)src[byte] >> sh;
            uint32_t got = 8 - sh;
            uint64_t b2 = byte + 1;
            while (got < sym_bits) {
                v |= (uint32_t)(b2 < n ? src[b2] : 0) << got;
                got += 8;
                ++b2;
            }
            vals[k] = v & (uint32_t)(A - 1);
        }
        // trailing pad bits must be zero (else re-pack cannot reproduce)
        const uint64_t used_bits = m * sym_bits;
        if (used_bits < n * 8) {
            const uint8_t tail = src[n - 1];
            const uint32_t keep = (uint32_t)(used_bits - (n - 1) * 8);
            if (keep < 8 && (tail >> keep) != 0) return -1;
            if (used_bits <= (n - 1) * 8) {
                // whole trailing bytes beyond the last value must be zero
                for (uint64_t b = used_bits / 8; b < n; ++b)
                    if ((b == used_bits / 8 && (used_bits & 7))
                            ? (src[b] >> (used_bits & 7)) != 0
                            : src[b] != 0)
                        return -1;
            }
        }
    }
    return rans_encode_vals_stream(vals.data(), m, src, n, sym_bits, 2,
                                   nways, out);
}

// GAP-mode encode of an LSB-first bitmap (flags 2|4): one 12-bit symbol
// per SET BIT (plus rare 4095-escapes for runs >= 4095 clear bits) instead
// of one per byte.  Returns the stream length, or -1 when gap coding
// cannot win (no set bits, or set bits outnumber bytes).  out capacity
// >= 2*n + 64 + 4*nways + 4*4096 (m <= n is enforced).
int64_t rans_compress_gaps(const uint8_t *src, uint64_t n, uint32_t nways,
                           uint8_t *out) {
    if (nways < 8 || (nways & (nways - 1)) != 0) return -1;
    static thread_local std::vector<uint32_t> vals;
    vals.clear();
    const uint64_t cap_m = n;       // beyond this gap coding loses anyway
    uint64_t prev_end = 0;          // position after the previous set bit
    for (uint64_t byte = 0; byte < n; ++byte) {
        uint8_t b = src[byte];
        while (b) {
            const uint32_t k = (uint32_t)__builtin_ctz((uint32_t)b);
            b = (uint8_t)(b & (b - 1));
            const uint64_t pos = byte * 8 + k;
            uint64_t gap = pos - prev_end;
            prev_end = pos + 1;
            while (gap >= 4095) {
                vals.push_back(4095);
                gap -= 4095;
                if (vals.size() > cap_m) return -1;
            }
            vals.push_back((uint32_t)gap);
            if (vals.size() > cap_m) return -1;
        }
    }
    if (vals.empty()) return -1;
    return rans_encode_vals_stream(vals.data(), vals.size(), src, n, 12, 6,
                                   nways, out);
}

// Symbol-mode decode (flags bit1 streams).  Returns original length or -1.
int64_t rans_decompress_symbols(const uint8_t *src, uint64_t len,
                                uint8_t *out, uint64_t cap) {
    if (len < 24 || src[0] != 0xA5 || src[1] != 1) return -1;
    if (src[2] > 16) return -1;
    const uint32_t nways = 1u << src[2];
    if (!(src[3] & 2)) return -1;
    auto get32 = [&](uint64_t pos) {
        return (uint64_t)src[pos] | ((uint64_t)src[pos + 1] << 8) |
               ((uint64_t)src[pos + 2] << 16) | ((uint64_t)src[pos + 3] << 24);
    };
    const uint64_t n = get32(4);
    const uint64_t m = get32(8);
    const uint64_t body_bytes = get32(12);
    uint64_t p = 20;
    if (n > cap) return -1;
    const bool gapmode = (src[3] & 4) != 0;
    const uint32_t sym_bits = src[p];
    if (sym_bits < 8 || sym_bits > 16) return -1;
    if (gapmode && sym_bits != 12) return -1;
    const int A = 1 << sym_bits;
    const uint32_t n_used = (uint32_t)src[p + 2] | ((uint32_t)src[p + 3] << 8);
    p += 4;
    if (n_used == 0 || n_used > (uint32_t)A ||
        p + 4ull * n_used + 4ull * nways + body_bytes + 4 > len)
        return -1;
    std::vector<uint32_t> sp_sym(n_used);
    std::vector<uint16_t> freq_all;  // sparse -> dense lazily via slot2sym
    uint32_t prev = 0;
    for (uint32_t k = 0; k < n_used; ++k) {
        sp_sym[k] = (uint32_t)src[p] | ((uint32_t)src[p + 1] << 8);
        if (sp_sym[k] >= (uint32_t)A || (k && sp_sym[k] <= prev)) return -1;
        prev = sp_sym[k];
        p += 2;
    }
    std::vector<uint16_t> sp_freq(n_used);
    uint32_t fsum = 0;
    for (uint32_t k = 0; k < n_used; ++k) {
        sp_freq[k] = (uint16_t)(src[p] | (src[p + 1] << 8));
        fsum += sp_freq[k];
        p += 2;
    }
    if (fsum != RANS_M12) return -1;
    // slot -> (sym, freq, cum)
    static thread_local std::vector<uint32_t> slot_sym, slot_freq, slot_cum;
    slot_sym.resize(RANS_M12);
    slot_freq.resize(RANS_M12);
    slot_cum.resize(RANS_M12);
    {
        uint32_t c = 0;
        for (uint32_t k = 0; k < n_used; ++k) {
            for (uint32_t t = 0; t < sp_freq[k]; ++t) {
                slot_sym[c + t] = sp_sym[k];
                slot_freq[c + t] = sp_freq[k];
                slot_cum[c + t] = c;
            }
            c += sp_freq[k];
        }
    }
    static thread_local std::vector<uint32_t> xs;
    xs.resize(nways);
    for (uint32_t w = 0; w < nways; ++w)
        xs[w] = (uint32_t)get32(p + 4ull * w);
    p += 4ull * nways;
    const uint8_t *body = src + p;
    p += body_bytes;
    if (p + 4 > len) return -1;

    std::memset(out, 0, n);
    int64_t bpos = (int64_t)body_bytes - 1;
    uint64_t bit = 0;
    uint64_t cur = 0;               // gap mode: next candidate bit index
    for (uint64_t k = 0; k < m; ++k, bit += sym_bits) {
        const uint32_t lane = (uint32_t)(k & (nways - 1));
        uint32_t x = xs[lane];
        const uint32_t slot = x & (RANS_M12 - 1);
        const uint32_t sym = slot_sym[slot];
        x = slot_freq[slot] * (x >> 12) + slot - slot_cum[slot];
        while (x < RANS_L12) {
            if (bpos < 0) return -1;
            x = (x << 8) | body[bpos--];
        }
        xs[lane] = x;
        if (gapmode) {
            // escape advances 4095 clear bits; a literal advances sym
            // clear bits and sets the next bit
            if (sym == 4095) {
                cur += 4095;
            } else {
                const uint64_t pos = cur + sym;
                if (pos >= n * 8) return -1;
                out[pos >> 3] |= (uint8_t)(1u << (pos & 7));
                cur = pos + 1;
            }
            continue;
        }
        // LSB-first pack of sym at bit offset
        uint64_t byte = bit >> 3;
        uint32_t sh = (uint32_t)(bit & 7);
        uint32_t v = sym << sh;
        uint32_t left = sym_bits + sh;
        while (left > 0 && byte < n) {
            out[byte] |= (uint8_t)v;
            v >>= 8;
            ++byte;
            left = left > 8 ? left - 8 : 0;
        }
    }
    const uint32_t MOD = 65521;
    uint32_t a = 1, b = 0;
    for (uint64_t k = 0; k < n; ++k) {
        a += out[k];
        if (a >= MOD) a -= MOD;
        b += a;
        if (b >= MOD) b -= MOD;
    }
    const uint32_t want = ((uint32_t)src[p] << 24) |
                          ((uint32_t)src[p + 1] << 16) |
                          ((uint32_t)src[p + 2] << 8) | (uint32_t)src[p + 3];
    return (((b << 16) | a) == want) ? (int64_t)n : -1;
}

}  // extern "C"
