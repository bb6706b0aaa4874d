// Hopper kernels of the ATA2 entropy pack: MTF, zero-run coding (RUNA/RUNB),
// the 257-symbol histogram and LSB-first bit packing of a (B, n) batch of BWT
// rows that already lies on the card.  Driven by archon_tpu_torch/ops/pack.py
// (mtf_rle, then pack_words once the host has built each row's Huffman codes
// from the histogram); the bytes are exactly those of the host pack
// (csrc/archon_host.cpp archon_mtf_rle0 and archon_bitpack16).
//
// They replace no TPU kernel: the JAX package packs on the host only
// (archon_tpu/entropy/pack.py).  They were added because the host pack of a
// 4 MiB block (about 80 ms on one core) left the card idle for most of an
// `archon e --pack` run, while L was already on the card.
//
// Chunks.  MTF is sequential, but the list just before position p is known
// without running it: the symbols of L[0:p] by their last occurrence, most
// recent first, then the unseen ones in ascending order.  So each row is cut
// into chunks of `chunk` bytes:
//   occ      one warp a chunk: each symbol's last occurrence in the chunk;
//   occ_scan an exclusive max-scan of those tables over each row's chunks:
//            each chunk's start state;
//   mtf      one warp a chunk.  The list is kept as a recency stamp per
//            symbol, T[s] (the last position of s, or -1 - s when unseen),
//            8 stamps a lane in registers; the rank of s is the number of
//            stamps above T[s] (one warp reduction), and the move to front
//            is one register write, T[s] = p.  Zero runs inside the chunk are
//            coded as they close, each nonzero rank v as v + 1, into the
//            chunk's own span of the (B, n) u16 scratch (a chunk never emits
//            more symbols than it has bytes); the run the chunk starts with,
//            and the one it ends with, are left to
//   rle_scan one block a row: a segmented scan over the chunks joins each
//            chunk's leading run to the trailing runs before it (the run
//            `zhead` coded at the chunk's start, `ztail` at the row's end),
//            adds their digits to the chunk's histogram, and sums the
//            histograms and symbol counts into the row's (hist, m).
// Then, with each row's code table:
//   bits_scan one block a row: each chunk's bit count (its histogram against
//            the code lengths) and their exclusive scan, the chunk's first bit;
//   words    one block a chunk: the chunk's codes ORed into its words in
//            shared memory at offsets from a block scan, then stored; a
//            chunk's first and last word, which it may share with its
//            neighbours, with atomicOr into the zeroed output.
//
// Bounds.  The whole pack needs about 4 bytes an input byte of traffic
// (L read twice, u16 symbols written and read, the words), about 0.04 ms
// for a unit of 8 x 4 MiB at 3.35 TB/s.  The MTF is bound instead by its
// serial chain within a chunk: about 50 instructions a byte for one warp,
// so thousands of chunks have to be in flight: 4 KiB chunks give 8192
// warps for that unit.  The per-chunk tables (1 KiB of stamps and 1 KiB of
// histogram a 4 KiB chunk) cost a quarter of L's bytes again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNsym = 257;            // NSYM in entropy/pack.py: RUNA, RUNB, ranks 1..255 as 2..256
constexpr int kHead = kNsym + 1;      // a row's histogram, then m
constexpr int kMeta = 6;              // META in ops/pack.py
constexpr int kWarps = 8;             // chunks a block in occ and mtf
constexpr int kScanThreads = 1024;    // rle_scan and bits_scan
constexpr int kPackThreads = 256;     // words
constexpr int kMaxChunk = 8192;       // MAX_CHUNK in ops/pack.py
constexpr unsigned kFull = 0xffffffffu;

// Wheeler's bijective base-2 digits of a zero run, least significant first:
// digit 1 is RUNA (0), digit 2 is RUNB (1).
__device__ __forceinline__ int run_digits(int32_t z) { return z > 0 ? 31 - __clz(z + 1) : 0; }

__device__ __forceinline__ int run_digit(int32_t z, int i) {
  for (int j = 0; j < i; ++j) {
    const int d = (z - 1) & 1;
    z = (z - d - 1) >> 1;
  }
  return (z - 1) & 1;
}

__device__ __forceinline__ void count_digits(int32_t z, int& runa, int& runb) {
  while (z > 0) {
    const int d = (z - 1) & 1;
    runa += d == 0;
    runb += d;
    z = (z - d - 1) >> 1;
  }
}

__device__ __forceinline__ int chunk_len(int n, int chunk, int k) { return min(chunk, n - k * chunk); }

__global__ void __launch_bounds__(kWarps * 32)
pack_occ_kernel(const uint8_t* __restrict__ L, int n, int chunk, int nch, int total,
                int32_t* __restrict__ occ) {
  __shared__ int32_t tab[kWarps][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  for (int s = lane; s < 256; s += 32) tab[warp][s] = -1;
  __syncwarp();
  if (g >= total) return;
  const int b = g / nch, k = g - b * nch;
  const int start = k * chunk, len = chunk_len(n, chunk, k);
  const uint8_t* src = L + (int64_t)b * n + start;
  for (int j = lane; j < len; j += 32) atomicMax(&tab[warp][src[j]], start + j);
  __syncwarp();
  int32_t* dst = occ + (int64_t)g * 256;
  for (int s = lane; s < 256; s += 32) dst[s] = tab[warp][s];
}

// grid (B, 8): 32 symbols a block, each of its 32 warps a segment of chunks.
__global__ void __launch_bounds__(1024) pack_occ_scan_kernel(int32_t* __restrict__ occ, int nch) {
  __shared__ int32_t part[32][33];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int per = (nch + 31) / 32;
  const int k0 = min(nch, seg * per), k1 = min(nch, k0 + per);
  int32_t* col = occ + (int64_t)blockIdx.x * nch * 256 + blockIdx.y * 32 + lane;
  int32_t m = -1;
  for (int k = k0; k < k1; ++k) m = max(m, col[(int64_t)k * 256]);
  part[seg][lane] = m;
  __syncthreads();
  int32_t run = -1;
  for (int q = 0; q < seg; ++q) run = max(run, part[q][lane]);
  for (int k = k0; k < k1; ++k) {
    const int32_t v = col[(int64_t)k * 256];
    col[(int64_t)k * 256] = run;
    run = max(run, v);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
pack_mtf_kernel(const uint8_t* __restrict__ L, int n, int chunk, int nch, int total,
                const int32_t* __restrict__ start, uint16_t* __restrict__ syms,
                int32_t* __restrict__ meta, int32_t* __restrict__ chist) {
  __shared__ int32_t hist[kWarps][kNsym + 3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  int* h = hist[warp];
  for (int s = lane; s < kNsym; s += 32) h[s] = 0;
  __syncwarp();
  if (g >= total) return;
  const int b = g / nch, k = g - b * nch;
  const int pos0 = k * chunk, len = chunk_len(n, chunk, k);
  const uint8_t* src = L + (int64_t)b * n + pos0;
  uint16_t* out = syms + (int64_t)b * n + pos0;

  int32_t t[8];  // stamp of symbol lane + 32 r
  const int32_t* st = start + (int64_t)g * 256;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int s = lane + 32 * r;
    const int32_t v = st[s];
    t[r] = v >= 0 ? v : -1 - s;
  }
  int cnt = 0;     // symbols written to the chunk's span
  int carry = 0;   // zeros since the chunk's last nonzero rank, or its start
  int lead = 0;    // zeros before the chunk's first nonzero rank
  bool seen = false;
  for (int base = 0; base < len; base += 32) {
    const int gsize = min(32, len - base);
    const int c = lane < gsize ? src[base + lane] : 0;
    unsigned my = 0;
    for (int i = 0; i < gsize; ++i) {
      const int s = __shfl_sync(kFull, c, i);
      const int q = s >> 5;
      // T[s] is register q of lane s & 31: a select tree of depth 3 (a chain of
      // 7 selects made the step 24% slower)
      const int32_t a0 = (q & 1) ? t[1] : t[0], a1 = (q & 1) ? t[3] : t[2];
      const int32_t a2 = (q & 1) ? t[5] : t[4], a3 = (q & 1) ? t[7] : t[6];
      const int32_t b0 = (q & 2) ? a1 : a0, b1 = (q & 2) ? a3 : a2;
      const int32_t v = (q & 4) ? b1 : b0;
      const int32_t ts = __shfl_sync(kFull, v, s & 31);
      unsigned above = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) above += t[r] > ts;
      const unsigned rank = __reduce_add_sync(kFull, above);
      const bool owner = lane == (s & 31);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (owner && q == r) t[r] = pos0 + base + i;
      if (lane == i) my = rank;
    }
    const bool nz = lane < gsize && my != 0;
    const unsigned mask = __ballot_sync(kFull, nz);
    const unsigned below = mask & ((1u << lane) - 1);
    const bool first = nz && !seen && below == 0;  // its run is the chunk's leading one
    const int run = below ? lane - (31 - __clz(below)) - 1 : lane + carry;
    const int d = nz ? 1 + (first ? 0 : run_digits(run)) : 0;
    int incl = d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (nz) {
      int p = cnt + incl - d;
      if (!first) {
        for (int z = run; z > 0;) {
          const int dg = (z - 1) & 1;
          out[p++] = (uint16_t)dg;
          atomicAdd(&h[dg], 1);
          z = (z - dg - 1) >> 1;
        }
      }
      out[p] = (uint16_t)(my + 1);
      atomicAdd(&h[my + 1], 1);
    }
    cnt += __shfl_sync(kFull, incl, 31);
    if (mask) {
      if (!seen) lead = __ffs(mask) - 1 + carry;
      seen = true;
      carry = gsize - 32 + __clz(mask);
    } else {
      carry += gsize;
    }
  }
  __syncwarp();
  if (lane == 0) {
    int32_t* mt = meta + (int64_t)g * kMeta;
    mt[0] = cnt;
    mt[1] = seen ? lead : len;
    mt[2] = carry;
    mt[3] = seen;
  }
  int32_t* ch = chist + (int64_t)g * kNsym;
  for (int s = lane; s < kNsym; s += 32) ch[s] = h[s];
}

// One block a row.  The zeros running into chunk k are a segmented sum over
// the chunks before it: (reset, value) = (seen, trail) for a chunk with a
// nonzero rank, (0, len) for one of zeros only.
__global__ void __launch_bounds__(kScanThreads)
pack_rle_scan_kernel(int32_t* __restrict__ meta, int32_t* __restrict__ chist,
                     int32_t* __restrict__ head, int n, int chunk, int nch) {
  __shared__ int32_t wr[32], wv[32];
  __shared__ int32_t tile_carry, sym_total;
  __shared__ int32_t red[4][kNsym];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* mrow = meta + (int64_t)b * nch * kMeta;
  int32_t* crow = chist + (int64_t)b * nch * kNsym;
  if (tid == 0) sym_total = 0;
  int32_t carry = 0;
  unsigned m = 0;
  for (int t0 = 0; t0 < nch; t0 += kScanThreads) {
    const int k = t0 + tid;
    const bool valid = k < nch;
    int32_t cnt = 0, lead = 0, trail = 0, seen = 0, len = 0;
    if (valid) {
      const int32_t* mt = mrow + (int64_t)k * kMeta;
      cnt = mt[0];
      lead = mt[1];
      trail = mt[2];
      seen = mt[3];
      len = chunk_len(n, chunk, k);
    }
    int r = valid ? seen : 0;
    int32_t v = valid ? (seen ? trail : len) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r2 = __shfl_up_sync(kFull, r, o);
      const int32_t v2 = __shfl_up_sync(kFull, v, o);
      if (lane >= o) {
        v = r ? v : v2 + v;
        r |= r2;
      }
    }
    if (lane == 31) {
      wr[warp] = r;
      wv[warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
      int rr = wr[lane];
      int32_t vv = wv[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int r2 = __shfl_up_sync(kFull, rr, o);
        const int32_t v2 = __shfl_up_sync(kFull, vv, o);
        if (lane >= o) {
          vv = rr ? vv : v2 + vv;
          rr |= r2;
        }
      }
      int er = __shfl_up_sync(kFull, rr, 1);
      int32_t ev = __shfl_up_sync(kFull, vv, 1);
      if (lane == 0) er = ev = 0;
      wr[lane] = er;
      wv[lane] = ev;
    }
    __syncthreads();
    const int32_t pv = wr[warp] ? wv[warp] : carry + wv[warp];  // zeros before the warp's first chunk
    const int32_t incl = r ? v : pv + v;
    int32_t before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = pv;
    if (valid) {
      const int32_t zhead = seen ? before + lead : 0;
      const int32_t ztail = k == nch - 1 ? (seen ? trail : before + len) : 0;
      int runa = 0, runb = 0;
      count_digits(zhead, runa, runb);
      count_digits(ztail, runa, runb);
      crow[(int64_t)k * kNsym] += runa;
      crow[(int64_t)k * kNsym + 1] += runb;
      mrow[(int64_t)k * kMeta + 4] = zhead;
      mrow[(int64_t)k * kMeta + 5] = ztail;
      m += (seen ? run_digits(zhead) + cnt : 0) + run_digits(ztail);
    }
    if (tid == kScanThreads - 1) tile_carry = incl;
    __syncthreads();
    carry = tile_carry;
    __syncthreads();
  }
  m = __reduce_add_sync(kFull, m);
  if (lane == 0) atomicAdd(&sym_total, (int32_t)m);
  for (int idx = tid; idx < 4 * kNsym; idx += kScanThreads) {
    const int q = idx / kNsym, c = idx - q * kNsym;
    int32_t s = 0;
    for (int k = q; k < nch; k += 4) s += crow[(int64_t)k * kNsym + c];
    red[q][c] = s;
  }
  __syncthreads();
  int32_t* hrow = head + (int64_t)b * kHead;
  for (int c = tid; c < kNsym; c += kScanThreads) hrow[c] = red[0][c] + red[1][c] + red[2][c] + red[3][c];
  if (tid == 0) hrow[kNsym] = sym_total;
}

// One block a row: chunk k's first bit in the row's stream.
__global__ void __launch_bounds__(kScanThreads)
pack_bits_scan_kernel(const int32_t* __restrict__ chist, const int32_t* __restrict__ lens,
                      const int64_t* __restrict__ row_word, int nch, int64_t* __restrict__ cbits) {
  __shared__ int32_t slen[kNsym];
  __shared__ int64_t sbits[kScanThreads];
  __shared__ int64_t wsum[32];
  __shared__ int64_t tile_total;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (row_word[b] < 0) return;
  for (int s = tid; s < kNsym; s += kScanThreads) slen[s] = lens[(int64_t)b * kNsym + s];
  __syncthreads();
  const int32_t* crow = chist + (int64_t)b * nch * kNsym;
  int64_t carry = 0;
  for (int t0 = 0; t0 < nch; t0 += kScanThreads) {
    for (int i = 0; i < 32; ++i) {
      const int k = t0 + warp * 32 + i;
      unsigned part = 0;
      if (k < nch)
        for (int s = lane; s < kNsym; s += 32) part += (unsigned)crow[(int64_t)k * kNsym + s] * slen[s];
      const unsigned tot = __reduce_add_sync(kFull, part);
      if (lane == 0) sbits[warp * 32 + i] = tot;
    }
    __syncthreads();
    const int64_t v = sbits[tid];
    int64_t incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int64_t w = wsum[lane];
      int64_t wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t x = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += x;
      }
      wsum[lane] = wi - w;
      if (lane == 31) tile_total = wi;
    }
    __syncthreads();
    const int k = t0 + tid;
    if (k < nch) cbits[(int64_t)b * nch + k] = carry + wsum[warp] + incl - v;
    carry += tile_total;
    __syncthreads();
  }
}

__device__ __forceinline__ int chunk_symbol(const uint16_t* src, int i, int dz, int cnt,
                                            int32_t zhead, int32_t ztail) {
  if (i < dz) return run_digit(zhead, i);
  if (i < dz + cnt) return src[i - dz];
  return run_digit(ztail, i - dz - cnt);
}

// One block a chunk: its symbols are zhead's digits, its span of the
// scratch, then (last chunk only) ztail's digits.
__global__ void __launch_bounds__(kPackThreads)
pack_words_kernel(const uint16_t* __restrict__ syms, const int32_t* __restrict__ meta,
                  const int64_t* __restrict__ cbits, const uint32_t* __restrict__ codes,
                  const int32_t* __restrict__ lens, const int64_t* __restrict__ row_word, int n,
                  int chunk, int nch, uint32_t* __restrict__ words) {
  extern __shared__ uint32_t sw[];
  __shared__ uint32_t scode[kNsym];
  __shared__ int32_t slen[kNsym];
  __shared__ uint32_t wsum[kPackThreads / 32];
  __shared__ uint32_t bits_total;
  const int g = blockIdx.x, b = g / nch, k = g - b * nch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t wrow = row_word[b];
  if (wrow < 0) return;
  const int32_t* mt = meta + (int64_t)g * kMeta;
  const int32_t cnt = mt[0], zhead = mt[4], ztail = mt[5];
  const int dz = mt[3] ? run_digits(zhead) : 0;
  const int total = dz + cnt + run_digits(ztail);
  if (total == 0) return;
  for (int s = tid; s < kNsym; s += kPackThreads) {
    scode[s] = codes[(int64_t)b * kNsym + s];
    slen[s] = lens[(int64_t)b * kNsym + s];
  }
  const uint16_t* src = syms + (int64_t)b * n + (int64_t)k * chunk;
  const int per = (total + kPackThreads - 1) / kPackThreads;
  const int i0 = min(total, tid * per), i1 = min(total, i0 + per);
  __syncthreads();
  uint32_t mine = 0;
  for (int i = i0; i < i1; ++i) mine += slen[chunk_symbol(src, i, dz, cnt, zhead, ztail)];
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (tid == 0) {
    uint32_t acc = 0;
    for (int w = 0; w < kPackThreads / 32; ++w) {
      const uint32_t x = wsum[w];
      wsum[w] = acc;
      acc += x;
    }
    bits_total = acc;
  }
  __syncthreads();
  const int64_t bit0 = cbits[(int64_t)b * nch + k];
  const uint32_t off0 = (uint32_t)(bit0 & 31);
  const int nw = (int)((off0 + bits_total + 31) >> 5);
  for (int j = tid; j < nw; j += kPackThreads) sw[j] = 0;
  __syncthreads();
  uint32_t pos = off0 + wsum[warp] + incl - mine;
  for (int i = i0; i < i1; ++i) {
    const int s = chunk_symbol(src, i, dz, cnt, zhead, ztail);
    const int l = slen[s];
    const uint32_t c = scode[s];
    const uint32_t r = pos & 31;
    atomicOr(&sw[pos >> 5], c << r);
    if (r + l > 32) atomicOr(&sw[(pos >> 5) + 1], c >> (32 - r));
    pos += l;
  }
  __syncthreads();
  uint32_t* dst = words + wrow + (bit0 >> 5);
  for (int j = tid; j < nw; j += kPackThreads) {
    if (j == 0 || j == nw - 1)
      atomicOr(dst + j, sw[j]);
    else
      dst[j] = sw[j];
  }
}

int chunks_of(int B, int n, int chunk, int* nch, int* total) {
  if (B < 1 || n < 1 || chunk < 1 || chunk > kMaxChunk) return 1;
  *nch = (n + chunk - 1) / chunk;
  const int64_t t = (int64_t)B * *nch;
  if (t > INT32_MAX || (int64_t)B * n > ((int64_t)1 << 40)) return 1;
  *total = (int)t;
  return 0;
}

}  // namespace

// occ (B, nch, 256) int32 scratch; syms (B, n) u16 scratch; meta (B, nch,
// kMeta) int32; chist (B, nch, kNsym) int32; head (B, kHead) int32.
extern "C" int archon_pack_mtf_rle(const uint8_t* L, int B, int n, int chunk, int32_t* occ,
                                   uint16_t* syms, int32_t* meta, int32_t* chist, int32_t* head,
                                   void* stream) {
  int nch, total;
  if (chunks_of(B, n, chunk, &nch, &total)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (total + kWarps - 1) / kWarps;
  pack_occ_kernel<<<blocks, kWarps * 32, 0, st>>>(L, n, chunk, nch, total, occ);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pack_occ_scan_kernel<<<dim3(B, 8), 1024, 0, st>>>(occ, nch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pack_mtf_kernel<<<blocks, kWarps * 32, 0, st>>>(L, n, chunk, nch, total, occ, syms, meta, chist);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pack_rle_scan_kernel<<<B, kScanThreads, 0, st>>>(meta, chist, head, n, chunk, nch);
  return (int)cudaGetLastError();
}

// codes, lens (B, kNsym); row_word (B,) int64: a row's first word in
// `words`, or -1 for a row not packed; cbits (B, nch) int64 scratch; words
// zeroed by the caller.
extern "C" int archon_pack_words(const uint16_t* syms, const int32_t* meta, const int32_t* chist,
                                 const uint32_t* codes, const int32_t* lens,
                                 const int64_t* row_word, int B, int n, int chunk, int64_t* cbits,
                                 uint32_t* words, void* stream) {
  int nch, total;
  if (chunks_of(B, n, chunk, &nch, &total)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  pack_bits_scan_kernel<<<B, kScanThreads, 0, st>>>(chist, lens, row_word, nch, cbits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t shared = (size_t)(chunk + 64) * sizeof(uint32_t);
  pack_words_kernel<<<total, kPackThreads, shared, st>>>(syms, meta, cbits, codes, lens, row_word,
                                                         n, chunk, nch, words);
  return (int)cudaGetLastError();
}
