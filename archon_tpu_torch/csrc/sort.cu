// Hopper sort kernels: per-tile bitonic sort (K1) and merge-path merge
// levels (K2).  Together, driven by archon_tpu_torch/ops/sort.py
// sort_operands, they are a stable lexicographic multi-key sort: the
// drop-in for every lax.sort site of the forward BWT (core/fast2.py).
//
// Replaces archon_tpu/ops/pallas_sort.py:
//   K1 sort_tiles_kernel   <- sort_tiles (:393) / _tile_sort_kernel (:385)
//   K2 merge_level_kernel  <- _merge_level (:317) / _merge_kernel (:265),
//                             with _merge_partition (:211) folded in: each
//                             block finds its own merge-path split.
//
// Data model.  Both kernels sort a PERMUTATION of element indices, never the
// keys themselves.  The keys are one (K, n) int32 row-major matrix that stays
// in device memory; a comparison reads keys[k][i] for k = 0.. until two
// differ.  So the key count K is a run-time value (the micro tail sorts 49
// keys at width 4096, which would not fit in shared memory as values), and
// payloads are never moved here: the wrapper gathers them by the final
// permutation.
//
// Stability / index-key rule.  A bitonic network is not stable, and the JAX
// pipeline relies on lax.sort's stability.  The comparator therefore ends
// with the element index itself: (keys[0], ..., keys[K-1], index) is a total
// order, and sorting by it is exactly a stable sort by the keys -- the same
// as appending an iota key last at every sort site.  Padding elements
// (index >= n, up to a multiple of the tile) compare greater than every real
// element and among themselves by index; their key values are never read,
// so 0x7FFFFFFF and negative keys (-1, the a4 off-end rank) are ordinary
// signed values here.
//
// What bounds them on the H100: every comparison is one or more dependent
// 4-byte loads of keys (L1/L2 when the compared indices are near each other,
// as in K1's tiles; scattered across the run pair in K2's later levels).
// K1 does log2(T)(log2(T)+1)/2 compare stages over T/2 pairs per tile;
// K2 does one compare per output plus log2(T) per thread for its split, and
// moves 8 bytes of permutation per element per level, log2(n/T) levels.
// The design keeps the permutation tile in shared memory (K1: the whole
// network; K2: the block's two input slices) so permutation traffic is one
// read and one write per pass; the key reads are the cost left for later
// work (caching the leading key beside the index).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortTile = 2048;     // K1 tile; TILE in ops/sort.py
constexpr int kSortThreads = kSortTile / 2;  // one compare-exchange each
constexpr int kMergeTile = 2048;    // outputs per K2 block
constexpr int kMergeThreads = 256;  // K2 threads per block
constexpr int kMergeItems = kMergeTile / kMergeThreads;

struct Keys {
  const int32_t* data;  // (K, n) row-major
  int64_t n;
  int K;
};

// (keys..., index) lexicographic less-than; padding (index >= n) sorts last.
__device__ __forceinline__ bool lex_less(const Keys& ks, int32_t a, int32_t b) {
  if (a >= ks.n || b >= ks.n) return a < b;
  const int32_t* p = ks.data;
  for (int k = 0; k < ks.K; ++k, p += ks.n) {
    const int32_t x = __ldg(p + a);
    const int32_t y = __ldg(p + b);
    if (x != y) return x < y;
  }
  return a < b;
}

// K1: one block per tile of kSortTile indices.  Writes perm[tile] = the
// tile's own indices in sorted order.  Full bitonic network in shared
// memory, one compare-exchange per thread per stage, one __syncthreads() per
// stage.
__global__ void __launch_bounds__(kSortThreads)
sort_tiles_kernel(Keys ks, int32_t* __restrict__ perm) {
  __shared__ int32_t s[kSortTile];
  const int64_t base = (int64_t)blockIdx.x * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads) s[i] = (int32_t)(base + i);
  __syncthreads();
  for (int k = 2; k <= kSortTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int t = threadIdx.x;
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
      const int32_t a = s[i];
      const int32_t b = s[i + j];
      const bool up = (i & k) == 0;
      if (up ? lex_less(ks, b, a) : lex_less(ks, a, b)) {
        s[i] = b;
        s[i + j] = a;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads) perm[base + i] = s[i];
}

// Number of A elements among the first `diag` outputs of merge(A, B).
__device__ __forceinline__ int merge_path(const Keys& ks, const int32_t* a, int na,
                                          const int32_t* b, int nb, int diag) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less(ks, a[mid], b[diag - 1 - mid])) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// K2: one merge level, sorted runs of `run` -> runs of 2*run.  Block b owns
// outputs [b*tile, (b+1)*tile) of one run pair (A, B); it finds its A/B
// ranges by two merge-path searches, stages them in shared memory, and each
// thread merges kMergeItems consecutive outputs from its own split.
__global__ void __launch_bounds__(kMergeThreads)
merge_level_kernel(Keys ks, const int32_t* __restrict__ in, int32_t* __restrict__ out,
                   int64_t n_pad, int64_t run) {
  __shared__ int32_t s[kMergeTile];
  __shared__ int split[2];
  const int64_t tile = min((int64_t)kMergeTile, 2 * run);
  const int64_t out0 = (int64_t)blockIdx.x * tile;
  const int64_t base = out0 / (2 * run) * (2 * run);
  const int la = (int)min(run, n_pad - base);
  const int lb = (int)max((int64_t)0, min(run, n_pad - base - run));
  const int32_t* A = in + base;
  const int32_t* B = A + la;  // read only when lb > 0, where la == run
  const int d0 = (int)(out0 - base);
  const int d1 = (int)min((int64_t)d0 + tile, (int64_t)la + lb);
  if (threadIdx.x == 0) split[0] = merge_path(ks, A, la, B, lb, d0);
  if (threadIdx.x == 32) split[1] = merge_path(ks, A, la, B, lb, d1);
  __syncthreads();
  const int a0 = split[0];
  const int na = split[1] - a0;
  const int cnt = d1 - d0;
  const int nb = cnt - na;
  const int b0 = d0 - a0;
  for (int i = threadIdx.x; i < na; i += blockDim.x) s[i] = A[a0 + i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s[na + i] = B[b0 + i];
  __syncthreads();
  const int diag = threadIdx.x * kMergeItems;
  if (diag >= cnt) return;
  const int32_t* sb = s + na;
  int ai = merge_path(ks, s, na, sb, nb, diag);
  int bi = diag - ai;
  const int m = min(kMergeItems, cnt - diag);
  int32_t* o = out + out0 + diag;
  for (int t = 0; t < m; ++t) {
    const bool take_a = bi >= nb || (ai < na && lex_less(ks, s[ai], sb[bi]));
    o[t] = take_a ? s[ai++] : sb[bi++];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// right after its launch; the Python wrapper raises when it is not 0.

extern "C" int archon_sort_tiles(const int32_t* keys, int64_t n, int K, int32_t* perm,
                                 int64_t n_pad, void* stream) {
  if (n_pad <= 0 || n_pad % kSortTile != 0) return (int)cudaErrorInvalidValue;
  const Keys ks{keys, n, K};
  sort_tiles_kernel<<<(unsigned)(n_pad / kSortTile), kSortThreads, 0, (cudaStream_t)stream>>>(
      ks, perm);
  return (int)cudaGetLastError();
}

extern "C" int archon_merge_level(const int32_t* keys, int64_t n, int K, const int32_t* in,
                                  int32_t* out, int64_t n_pad, int64_t run, void* stream) {
  const Keys ks{keys, n, K};
  const int64_t tile = 2 * run < kMergeTile ? 2 * run : kMergeTile;
  const int64_t blocks = (n_pad + tile - 1) / tile;
  merge_level_kernel<<<(unsigned)blocks, kMergeThreads, 0, (cudaStream_t)stream>>>(
      ks, in, out, n_pad, run);
  return (int)cudaGetLastError();
}
