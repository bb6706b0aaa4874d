// archon_host: native host-side runtime for archon_tpu.
//
// The TPU owns the transform math; this library owns the host runtime the
// reference implemented in C (SURVEY.md section 2: "every performance-relevant
// component is native"): the serial LF chain walk used by decode paths and
// verification oracles (a6/src/bwt.c:459-478, a7/src/archon.cpp:903-943),
// histogramming, the bit-stream codec (a6/src/coder.c:108-123), and a
// mmap-backed block reader (the x1 streaming loop, final/x1/ArchonX1.c:53-60).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// histogram256: byte frequency count.
// ---------------------------------------------------------------------------
void archon_histogram256(const uint8_t* data, int64_t n, int64_t* out) {
    int64_t h[4][256] = {};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        ++h[0][data[i]];
        ++h[1][data[i + 1]];
        ++h[2][data[i + 2]];
        ++h[3][data[i + 3]];
    }
    for (; i < n; ++i) ++h[0][data[i]];
    for (int c = 0; c < 256; ++c)
        out[c] = h[0][c] + h[1][c] + h[2][c] + h[3][c];
}

// ---------------------------------------------------------------------------
// LF successor build + chain walk (decode).  sentinel_large selects the
// base-last counter roll (a7/a6 convention, a7/src/archon.cpp:929-931);
// otherwise base rolls first (a4, a4/src/archon.c:255-257).  P is
// caller-allocated scratch of n int32.  Returns 0 on success, -1 on bad
// input.
//
// The walk is a dependent pointer chase — the one inherently serial loop of
// the whole codec — so the design attacks its MEMORY behavior instead of its
// data dependency:
//
//  1. Packed table (n <= 2^24): T[i] = (successor << 8) | byte reuses the P
//     scratch as u32, so a chase step costs ONE cache miss, not two (L[] and
//     P[] live in the same line as their index).
//  2. Cycle segmentation: every index is on the single LF cycle, so the
//     multiples of a power-of-two stride S cut it into K = ceil(n/S)
//     segments whose concatenation (in cycle order, discovered on the fly)
//     is the output.  Start membership is a mask test — no bitmap.
//  3. Memory-level parallelism: each worker thread walks 16 segments in
//     round-robin lockstep, keeping ~16 independent misses in flight per
//     core where the textbook walk keeps exactly 1; segments are then
//     stitched with sequential memcpy (bandwidth-cheap).
//
// This replaces the reference's run-splice trick (a6/src/bwt.c:484-525) —
// a uniprocessor cache optimization — with latency-hiding that scales with
// cores x MLP.  The table build is parallelized the same way: per-chunk
// symbol histograms + an exclusive combine give each chunk an independent
// rank window (the base position's out-of-order roll handled exactly).
// ---------------------------------------------------------------------------

static const int kSegLog = 12;  // segment stride 4096
static const int kLanes = 16;   // interleaved chains per worker thread

static int walk_threads(int64_t n) {
    unsigned hc = std::thread::hardware_concurrency();
    if (hc == 0) hc = 1;
    int64_t by_work = n >> 16;  // don't spin threads for < 64 KiB each
    int t = (int)(by_work < (int64_t)hc ? (by_work < 1 ? 1 : by_work) : hc);
    return t > 32 ? 32 : t;
}

// Parallel build of the packed successor table T (u32: successor<<8 | byte).
// Computes the bucket starts itself from its per-chunk histograms (one
// parallel pass serves both jobs — no separate serial histogram).
static void build_packed_table(const uint8_t* L, int64_t n, int64_t base,
                               int sentinel_large, uint32_t* T, int nthreads,
                               const int64_t* custom_starts = nullptr) {
    const uint8_t cb = L[base];
    std::vector<std::vector<int64_t>> hist((size_t)nthreads,
                                           std::vector<int64_t>(256, 0));
    const int64_t chunk = (n + nthreads - 1) / nthreads;
    auto histo = [&](int t) {
        const int64_t i0 = t * chunk, i1 = i0 + chunk < n ? i0 + chunk : n;
        int64_t* h = hist[(size_t)t].data();
        for (int64_t i = i0; i < i1; ++i) ++h[L[i]];
        if (i0 <= base && base < i1) --h[cb];  // base rolls out of order
    };
    {
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; ++t) ts.emplace_back(histo, t);
        histo(0);
        for (auto& th : ts) th.join();
    }
    // bucket starts R from the chunk hists (re-adding base's count), or the
    // caller's (e.g. the a6 var inverse's Huffman-code-ordered buckets)
    int64_t R[256];
    if (custom_starts) {
        memcpy(R, custom_starts, sizeof(R));
    } else {
        int64_t k = n;
        for (int c = 256; c--;) {
            int64_t total = (c == cb) ? 1 : 0;
            for (int t = 0; t < nthreads; ++t) total += hist[(size_t)t][(size_t)c];
            R[c] = (k -= total);
        }
    }
    // exclusive combine: chunk t's rank window per symbol
    std::vector<std::vector<int64_t>> off((size_t)nthreads,
                                          std::vector<int64_t>(256, 0));
    for (int c = 0; c < 256; ++c) {
        // small sentinel: base rolls FIRST, shifting every other L[i]==cb by 1
        int64_t run = R[c] + (!sentinel_large && c == cb ? 1 : 0);
        for (int t = 0; t < nthreads; ++t) {
            off[(size_t)t][(size_t)c] = run;
            run += hist[(size_t)t][(size_t)c];
        }
    }
    auto fill = [&](int t) {
        const int64_t i0 = t * chunk, i1 = i0 + chunk < n ? i0 + chunk : n;
        int64_t* o = off[(size_t)t].data();
        for (int64_t i = i0; i < i1; ++i) {
            if (i == base) continue;
            const uint8_t c = L[i];
            T[i] = ((uint32_t)o[c]++ << 8) | c;
        }
    };
    {
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; ++t) ts.emplace_back(fill, t);
        fill(0);
        for (auto& th : ts) th.join();
    }
    // base's own successor: first rank (small) or last rank (large) of cb
    int64_t nb = R[cb];
    if (sentinel_large) {
        int64_t total = 0;
        for (int t = 0; t < nthreads; ++t) total += hist[(size_t)t][cb];
        nb += total;
    }
    T[base] = ((uint32_t)nb << 8) | cb;
}

// Segmented MLP walk over the packed table.  Returns 0, or -1 if the chain
// structure is inconsistent (corrupt payload).
static int segmented_walk(const uint32_t* T, int64_t n, int64_t base,
                          uint8_t* out, int nthreads) {
    const int64_t S = (int64_t)1 << kSegLog;
    const int64_t mask = S - 1;
    const int64_t nreg = ((n - 1) >> kSegLog) + 1;
    const int base_extra = (base & mask) != 0;
    const int64_t K = nreg + base_extra;
    auto sid = [&](int64_t p) -> int64_t {
        return (p & mask) ? nreg : p >> kSegLog;  // non-multiple start == base
    };
    std::vector<std::vector<uint8_t>> seg((size_t)K);
    std::vector<int64_t> next_start((size_t)K, -1);
    std::atomic<int64_t> cursor{0};
    std::atomic<bool> bad{false};
    auto work = [&]() {
        int64_t ids[kLanes];
        uint32_t es[kLanes];
        std::vector<uint8_t>* bufs[kLanes];
        int active = 0;
        auto refill = [&]() {
            while (active < kLanes) {
                const int64_t g = cursor.fetch_add(1);
                if (g >= K) break;
                const int64_t p = g < nreg ? g << kSegLog : base;
                ids[active] = g;
                es[active] = T[p];
                bufs[active] = &seg[(size_t)g];
                bufs[active]->reserve((size_t)(S + S / 2));
                ++active;
            }
        };
        refill();
        while (active && !bad.load(std::memory_order_relaxed)) {
            for (int t = 0; t < active; ++t) {
                const uint32_t e = es[t];
                bufs[t]->push_back((uint8_t)e);
                const int64_t q = e >> 8;
                if ((q & mask) == 0 || q == base) {
                    next_start[(size_t)ids[t]] = q;
                    --active;
                    ids[t] = ids[active];
                    es[t] = es[active];
                    bufs[t] = bufs[active];
                    --t;
                } else {
                    if (bufs[t]->size() > (size_t)n) {  // corrupt: loop
                        bad.store(true, std::memory_order_relaxed);
                        break;
                    }
                    es[t] = T[q];
                }
            }
            refill();
        }
    };
    {
        std::vector<std::thread> ts;
        for (int t = 1; t < nthreads; ++t) ts.emplace_back(work);
        work();
        for (auto& th : ts) th.join();
    }
    if (bad.load()) return -1;
    // stitch in cycle order starting from base's segment
    std::vector<uint8_t> visited((size_t)K, 0);
    int64_t cur = sid(base), done = 0;
    uint8_t* w = out;
    for (int64_t c = 0; c < K; ++c) {
        if (cur < 0 || cur >= K || visited[(size_t)cur]) return -1;
        visited[(size_t)cur] = 1;
        const std::vector<uint8_t>& b = seg[(size_t)cur];
        memcpy(w, b.data(), b.size());
        w += b.size();
        done += (int64_t)b.size();
        const int64_t ns = next_start[(size_t)cur];
        if (ns < 0) return -1;
        cur = sid(ns);
        if (cur == sid(base)) break;
    }
    return done == n ? 0 : -1;
}

int archon_unbwt(const uint8_t* L, int64_t n, int64_t base, int sentinel_large,
                 int32_t* P, uint8_t* out) {
    if (n <= 0 || base < 0 || base >= n) return n == 0 ? 0 : -1;
    if (n <= (int64_t)1 << 24) {
        // packed successor table in the P scratch (fits u32 up to 2^24,
        // the 16 MiB production block ceiling)
        const int nthreads = walk_threads(n);
        if (nthreads > 1) {  // histograms its own chunks; no serial R pass
            uint32_t* T = (uint32_t*)P;
            build_packed_table(L, n, base, sentinel_large, T, nthreads);
            return segmented_walk(T, n, base, out, nthreads);
        }
    }
    int64_t R[256] = {};
    for (int64_t i = 0; i < n; ++i) ++R[L[i]];
    int64_t k = n;
    for (int c = 256; c--;) R[c] = (k -= R[c]);

    if (n <= (int64_t)1 << 24) {
        uint32_t* T = (uint32_t*)P;
        if (sentinel_large) {
            for (int64_t i = 0; i < base; ++i)
                T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
            for (int64_t i = base + 1; i < n; ++i)
                T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
            T[base] = ((uint32_t)R[L[base]]++ << 8) | L[base];
        } else {
            T[base] = ((uint32_t)R[L[base]]++ << 8) | L[base];
            for (int64_t i = 0; i < base; ++i)
                T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
            for (int64_t i = base + 1; i < n; ++i)
                T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
        }
        uint32_t e = T[base];
        for (int64_t i = 0; i < n; ++i) {
            out[i] = (uint8_t)e;
            e = T[e >> 8];
        }
        return 0;
    }

    if (sentinel_large) {
        for (int64_t i = 0; i < base; ++i) P[i] = (int32_t)R[L[i]]++;
        for (int64_t i = base + 1; i < n; ++i) P[i] = (int32_t)R[L[i]]++;
        P[base] = (int32_t)R[L[base]]++;
    } else {
        P[base] = (int32_t)R[L[base]]++;
        for (int64_t i = 0; i < base; ++i) P[i] = (int32_t)R[L[i]]++;
        for (int64_t i = base + 1; i < n; ++i) P[i] = (int32_t)R[L[i]]++;
    }
    int32_t kk = (int32_t)base;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = L[kk];
        kk = P[kk];
    }
    return 0;
}

// Starts-parameterized inverse (the a6 'var' inverse: Huffman-code-ordered
// bucket starts, a6/src/bwt.c:459-478 with the code-order fix the
// reference's own -u lacks — see golden/a6.py).  Base-last (large) roll.
int archon_unbwt_starts(const uint8_t* L, int64_t n, int64_t base,
                        const int64_t* starts, int32_t* P, uint8_t* out) {
    if (n <= 0 || base < 0 || base >= n) return n == 0 ? 0 : -1;
    if (n <= (int64_t)1 << 24) {
        const int nthreads = walk_threads(n);
        uint32_t* T = (uint32_t*)P;
        if (nthreads > 1) {
            build_packed_table(L, n, base, /*sentinel_large=*/1, T, nthreads,
                               starts);
            return segmented_walk(T, n, base, out, nthreads);
        }
        int64_t R[256];
        memcpy(R, starts, sizeof(R));
        for (int64_t i = 0; i < base; ++i)
            T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
        for (int64_t i = base + 1; i < n; ++i)
            T[i] = ((uint32_t)R[L[i]]++ << 8) | L[i];
        T[base] = ((uint32_t)R[L[base]]++ << 8) | L[base];
        uint32_t e = T[base];
        for (int64_t i = 0; i < n; ++i) {
            out[i] = (uint8_t)e;
            e = T[e >> 8];
        }
        return 0;
    }
    int64_t R[256];
    memcpy(R, starts, sizeof(R));
    for (int64_t i = 0; i < base; ++i) P[i] = (int32_t)R[L[i]]++;
    for (int64_t i = base + 1; i < n; ++i) P[i] = (int32_t)R[L[i]]++;
    P[base] = (int32_t)R[L[base]]++;
    int32_t k = (int32_t)base;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = L[k];
        k = P[k];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// LF verification of a suffix-array payload (vectorizing a4's verify(),
// a4/src/archon.c:210-225, for host-side oracle use): checks that (L, base)
// is self-consistent as a BWT stream, i.e. the LF walk visits every index
// exactly once.  Returns 0 if consistent.
// ---------------------------------------------------------------------------
int archon_verify_cycle(const uint8_t* L, int64_t n, int64_t base,
                        int sentinel_large, int32_t* P, uint8_t* seen) {
    if (n == 0) return 0;
    uint8_t tmp_out;
    (void)tmp_out;
    int rc = 0;
    // build successor table (same as unbwt)
    {
        int64_t R[256] = {};
        for (int64_t i = 0; i < n; ++i) ++R[L[i]];
        int64_t k = n;
        for (int c = 256; c--;) R[c] = (k -= R[c]);
        if (sentinel_large) {
            for (int64_t i = 0; i < base; ++i) P[i] = (int32_t)R[L[i]]++;
            for (int64_t i = base + 1; i < n; ++i) P[i] = (int32_t)R[L[i]]++;
            P[base] = (int32_t)R[L[base]]++;
        } else {
            P[base] = (int32_t)R[L[base]]++;
            for (int64_t i = 0; i < base; ++i) P[i] = (int32_t)R[L[i]]++;
            for (int64_t i = base + 1; i < n; ++i) P[i] = (int32_t)R[L[i]]++;
        }
    }
    memset(seen, 0, (size_t)n);
    int32_t k = (int32_t)base;
    for (int64_t i = 0; i < n; ++i) {
        if (seen[k]) { rc = -1; break; }
        seen[k] = 1;
        k = P[k];
    }
    return rc;
}

// ---------------------------------------------------------------------------
// Bit-stream codec (a6 semantics: codes packed LSB-first at increasing bit
// offsets into 32-bit little-endian words, a6/src/coder.c:108-123).
// code_values/code_lengths indexed by symbol.  Returns total bits.
// ---------------------------------------------------------------------------
int64_t archon_bitpack(const uint8_t* data, int64_t n,
                       const uint32_t* code_values, const uint8_t* code_lengths,
                       uint32_t* words) {
    int64_t k = 0;
    words[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t c = code_values[data[i]];
        const int len = code_lengths[data[i]];
        const int64_t k2 = k + len;
        words[k >> 5] |= c << (k & 31);
        if ((k >> 5) != (k2 >> 5))
            words[k2 >> 5] = (len && (k & 31)) ? (c >> (32 - (k & 31))) : 0;
        k = k2;
    }
    return k;
}

// Decode n symbols from the packed stream.  The a6 stream is *backward*
// decodable by construction: codes are packed LSB-first from their start
// offset, so reading bits downward from a codeword's END yields the code
// MSB-first, where the Huffman prefix-free property makes greedy matching
// unique (this is exactly how the reference's sort and get_char consume the
// stream, a6/src/bwt.c:112-144).  A forward LSB-aligned match would be
// ambiguous.  Decodes back-to-front, emitting into out[n-1]..out[0].
// First-bits table decode (the TPU-era answer to the reference's
// DECODE_BITS=12 offset+list buckets, a6/src/coder.c:130-209): a
// direct-mapped 4096-entry table resolves every code of length <= 12 in one
// load + one shift — no bucket list scan at all.  Codes longer than 12 bits
// (rare: Huffman assigns them only to symbols with frequency < n/2^12) fall
// back to per-length candidate lists.  The stream is read backward: a
// codeword ends at bit `pos`, its MSB sits at stream bit pos-1, so the 12
// stream bits [pos-12, pos) ARE the window with the code left-aligned at the
// top — a code c of length l matches iff window >> (12-l) == c.
static const int kDecodeBits = 12;

static inline uint32_t load_bits(const uint8_t* bytes, int64_t b, int l) {
    // bits [b, b+l) of the little-endian bit stream, l <= 25
    uint32_t w;
    memcpy(&w, bytes + (b >> 3), 4);
    return (w >> (b & 7)) & ((l == 32) ? 0xFFFFFFFFu : ((1u << l) - 1u));
}

static inline uint64_t load_bits64(const uint8_t* bytes, int64_t b, int l) {
    uint64_t w;
    memcpy(&w, bytes + (b >> 3), 8);
    return (w >> (b & 7)) & ((l == 64) ? ~0ull : ((1ull << l) - 1ull));
}

int64_t archon_bitunpack(const uint32_t* words, int64_t total_bits,
                         const uint32_t* code_values, const uint8_t* code_lengths,
                         uint8_t* out, int64_t n) {
    const uint8_t* bytes = (const uint8_t*)words;
    // --- build the direct-mapped table: entry = (sym << 8) | len, 0 = escape
    uint16_t table[1 << kDecodeBits] = {};
    // per-length candidate lists for long codes (l in 13..32)
    uint8_t long_syms[33][256];
    int long_cnt[33] = {};
    for (int s = 0; s < 256; ++s) {
        const int l = code_lengths[s];
        if (!l) continue;
        if (l <= kDecodeBits) {
            const uint32_t lo = code_values[s] << (kDecodeBits - l);
            const uint32_t span = 1u << (kDecodeBits - l);
            for (uint32_t w = lo; w < lo + span; ++w)
                table[w] = (uint16_t)((s << 8) | l);
        } else if (l <= 32) {
            long_syms[l][long_cnt[l]++] = (uint8_t)s;
        }
    }
    int64_t pos = total_bits;
    for (int64_t j = n; j-- > 0;) {
        int sym = -1, l = 0;
        if (pos >= kDecodeBits) {
            const uint32_t w = load_bits(bytes, pos - kDecodeBits, kDecodeBits);
            const uint16_t e = table[w];
            if (e) {
                sym = e >> 8;
                l = e & 0xFF;
            } else {
                // long code: try lengths 13..32 in increasing order
                // (prefix-free => the first match is the unique one)
                for (l = kDecodeBits + 1; l <= 32 && l <= pos; ++l) {
                    if (!long_cnt[l]) continue;
                    const uint64_t acc = load_bits64(bytes, pos - l, l);
                    for (int t = 0; t < long_cnt[l]; ++t) {
                        const int s = long_syms[l][t];
                        if (code_values[s] == (uint32_t)acc) { sym = s; break; }
                    }
                    if (sym >= 0) break;
                }
            }
        } else {
            // stream head (< 12 bits left): incremental MSB-first scan
            uint32_t acc = 0;
            for (l = 1; l <= pos; ++l) {
                const int64_t b = pos - l;
                acc = (acc << 1) | ((words[b >> 5] >> (b & 31)) & 1u);
                for (int s = 0; s < 256; ++s) {
                    if (code_lengths[s] == l && code_values[s] == acc) {
                        sym = s;
                        break;
                    }
                }
                if (sym >= 0) break;
            }
        }
        if (sym < 0) return -1;
        out[j] = (uint8_t)sym;
        pos -= l;
    }
    return pos;  // 0 when the stream was fully consumed
}

// ---------------------------------------------------------------------------
// Block entropy pack: MTF + RLE0 + (caller-supplied) Huffman over a 257-ary
// symbol stream — the bzip-class back end the packed container (ATA2)
// applies per block.  The reference family stops at the BWT (a6 emits raw
// decoded symbols, a6/src/bwt.c:303-335) and states compression parity with
// YBS/SBC/bzip as the goal (README.md:17); this is that back end, with the
// run coding in Wheeler's bijective base-2 (the bzip2 RUNA/RUNB scheme) so
// zero-run lengths cost O(log run).
//
// Symbol alphabet (u16): 0 = RUNA, 1 = RUNB, MTF value v in 1..255 -> v+1.
// ---------------------------------------------------------------------------

static inline int64_t emit_run(int64_t run, uint16_t* syms, int64_t m) {
    // bijective base-2 digits of `run`, LSB-first: d in {1,2} mapped to
    // RUNA(0)/RUNB(1)
    while (run > 0) {
        int64_t d = (run - 1) & 1;  // 0 -> digit 1 (RUNA), 1 -> digit 2 (RUNB)
        syms[m++] = (uint16_t)d;
        run = (run - d - 1) >> 1;
    }
    return m;
}

int64_t archon_mtf_rle0(const uint8_t* L, int64_t n, uint16_t* syms) {
    uint8_t mtf[256];
    for (int i = 0; i < 256; ++i) mtf[i] = (uint8_t)i;
    int64_t m = 0, run = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t c = L[i];
        int j = 0;
        while (mtf[j] != c) ++j;
        if (j == 0) {
            ++run;
            continue;
        }
        m = emit_run(run, syms, m);
        run = 0;
        memmove(mtf + 1, mtf, (size_t)j);
        mtf[0] = c;
        syms[m++] = (uint16_t)(j + 1);
    }
    return emit_run(run, syms, m);
}

int64_t archon_unrle0_unmtf(const uint16_t* syms, int64_t m, uint8_t* out,
                            int64_t n) {
    uint8_t mtf[256];
    for (int i = 0; i < 256; ++i) mtf[i] = (uint8_t)i;
    int64_t w = 0;
    int64_t run = 0, scale = 1;
    for (int64_t i = 0; i < m; ++i) {
        const uint16_t s = syms[i];
        if (s <= 1) {
            run += scale * (int64_t)(s + 1);
            scale <<= 1;
            continue;
        }
        if (run) {
            if (w + run > n) return -1;
            memset(out + w, mtf[0], (size_t)run);
            w += run;
            run = 0;
            scale = 1;
        }
        const int j = s - 1;
        if (j > 255) return -1;
        const uint8_t c = mtf[j];
        if (w >= n) return -1;
        memmove(mtf + 1, mtf, (size_t)j);
        mtf[0] = c;
        out[w++] = c;
    }
    if (run) {
        if (w + run > n) return -1;
        memset(out + w, mtf[0], (size_t)run);
        w += run;
    }
    return w == n ? 0 : -1;
}

// u16-symbol variants of the bit-stream codec (same a6 stream semantics:
// LSB-first packing, backward-decodable, first-bits decode table).
int64_t archon_bitpack16(const uint16_t* syms, int64_t m,
                         const uint32_t* code_values, const uint8_t* code_lengths,
                         uint32_t* words) {
    int64_t k = 0;
    words[0] = 0;
    for (int64_t i = 0; i < m; ++i) {
        const uint32_t c = code_values[syms[i]];
        const int len = code_lengths[syms[i]];
        const int64_t k2 = k + len;
        words[k >> 5] |= c << (k & 31);
        if ((k >> 5) != (k2 >> 5))
            words[k2 >> 5] = (len && (k & 31)) ? (c >> (32 - (k & 31))) : 0;
        k = k2;
    }
    return k;
}

int64_t archon_bitunpack16(const uint32_t* words, int64_t total_bits,
                           const uint32_t* code_values,
                           const uint8_t* code_lengths, int nsym,
                           uint16_t* out, int64_t m) {
    const uint8_t* bytes = (const uint8_t*)words;
    uint32_t table[1 << kDecodeBits] = {};  // (sym+1) << 8 | len; 0 = escape
    int long_syms[33][512];
    int long_cnt[33] = {};
    for (int s = 0; s < nsym; ++s) {
        const int l = code_lengths[s];
        if (!l) continue;
        if (l <= kDecodeBits) {
            const uint32_t lo = code_values[s] << (kDecodeBits - l);
            const uint32_t span = 1u << (kDecodeBits - l);
            for (uint32_t w = lo; w < lo + span; ++w)
                table[w] = (uint32_t)(((s + 1) << 8) | l);
        } else if (l <= 32) {
            long_syms[l][long_cnt[l]++] = s;
        }
    }
    int64_t pos = total_bits;
    for (int64_t j = m; j-- > 0;) {
        int sym = -1, l = 0;
        if (pos >= kDecodeBits) {
            const uint32_t w = load_bits(bytes, pos - kDecodeBits, kDecodeBits);
            const uint32_t e = table[w];
            if (e) {
                sym = (int)(e >> 8) - 1;
                l = (int)(e & 0xFF);
            } else {
                for (l = kDecodeBits + 1; l <= 32 && l <= pos; ++l) {
                    if (!long_cnt[l]) continue;
                    const uint64_t acc = load_bits64(bytes, pos - l, l);
                    for (int t = 0; t < long_cnt[l]; ++t) {
                        const int s = long_syms[l][t];
                        if (code_values[s] == (uint32_t)acc) { sym = s; break; }
                    }
                    if (sym >= 0) break;
                }
            }
        } else {
            uint32_t acc = 0;
            for (l = 1; l <= pos; ++l) {
                const int64_t b = pos - l;
                acc = (acc << 1) | ((words[b >> 5] >> (b & 31)) & 1u);
                for (int s = 0; s < nsym; ++s) {
                    if (code_lengths[s] == l && code_values[s] == acc) {
                        sym = s;
                        break;
                    }
                }
                if (sym >= 0) break;
            }
        }
        if (sym < 0) return -1;
        out[j] = (uint16_t)sym;
        pos -= l;
    }
    return pos;  // 0 when the stream was fully consumed
}

// ---------------------------------------------------------------------------
// mmap block reader: data-loader for the streaming pipeline.
// ---------------------------------------------------------------------------
struct ArchonMap {
    void* addr;
    int64_t size;
    int fd;
};

void* archon_map_open(const char* path, int64_t* size_out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
    }
    void* addr = nullptr;
    if (st.st_size > 0) {
        addr = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (addr == MAP_FAILED) {
            close(fd);
            return nullptr;
        }
        madvise(addr, (size_t)st.st_size, MADV_SEQUENTIAL);
    }
    ArchonMap* m = new ArchonMap{addr, (int64_t)st.st_size, fd};
    *size_out = m->size;
    return m;
}

const uint8_t* archon_map_data(void* handle) {
    return (const uint8_t*)((ArchonMap*)handle)->addr;
}

void archon_map_close(void* handle) {
    ArchonMap* m = (ArchonMap*)handle;
    if (m->addr) munmap(m->addr, (size_t)m->size);
    close(m->fd);
    delete m;
}

}  // extern "C"
