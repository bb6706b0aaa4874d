// Hopper sort kernels: per-tile sort (K1) and merge-path merge levels (K2).
// Together, driven by archon_tpu_torch/ops/sort.py sort_operands (and, for a
// batch of rows laid end to end, sort_rows), they are a stable lexicographic
// multi-key sort: the drop-in for every lax.sort site of the forward BWT, its
// batched form, a6 and the device inverse.
//
// Replaces archon_tpu/ops/pallas_sort.py:
//   K1 sort_tiles_kernel       <- sort_tiles (:393) / _tile_sort_kernel (:385)
//   K2 merge_partition_kernel  <- _merge_partition (:211)
//      merge_level_kernel      <- _merge_level (:317) / _merge_kernel (:265)
// K2 is the two launches of one archon_merge_level call: the split pass,
// then the merge.  The file also holds the sharded megablock's stage merge
// (stage_split_kernel + stage_merge_kernel, archon_stage_merge), which
// replaces no TPU kernel and shares K2's device helpers; see its section.
//
// Data model: carried tuples.  Like the Pallas kernels, which carry their
// operand values through every level, both kernels move (key_0 .. key_{C-1},
// index) tuples, struct-of-arrays: a (C+1, n_pad) int32 buffer, row C the
// element index.  C = min(K, kMaxCarry) is a template parameter, so a tuple
// lives in registers and every comparison reads registers or shared memory.
// When K > C (the micro tail's 13 and 49 keys) the keys past the first C
// are read from the (K, n) key matrix by index, and only when every carried
// key ties.
//
// Order and padding.  Tuples compare on (keys..., index): the index is the
// implicit last key, unique, so the order is total and equal to a stable
// sort by the keys, which a merge network is not by itself.  Padding up to
// a tile multiple carries index >= n and every key 0x7FFFFFFF, so the same
// comparison puts it after every real element, a real all-0x7FFFFFFF one
// included, with no branch for it; 0x7FFFFFFF and -1 stay ordinary keys.
//
// K1: one block of kTileThreads sorts a kSortTile-element tile (8192: 2
// fewer K2 levels than a 2048 tile).  Its merge rounds are bound by the
// latency of dependent shared-memory reads: each merge step reads the next
// element at a data-dependent place, each search step two.  So K1 keeps
// those chains short and runs many of them: 1024 threads (32 warps on the
// SM) of 8 elements each, and each element is a slot, (key 0, position in
// the tile) in one 8-byte word, so a step is one read where a tuple would be
// C+1.  Keys 1..C-1 stay where the tile was loaded and are read by position
// only when key 0 ties.  Each thread sorts its slots in registers (a bitonic
// network), then log2(kTileThreads) rounds merge in shared memory, each
// thread finding its own merge-path diagonal by binary search and merging
// kTileItems outputs serially.  The last round writes the tuples from
// registers: key 0 from the slot, keys 1..C-1 by position, the index as
// tile start + position.  Shared memory holds keys 1..C-1 and the slots
// (164 KB at C = 4, above the 48 KB default, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize and checks it).  Global
// traffic is one coalesced read of C keys and one write of C+1 rows.
//
// K2: one merge level, sorted runs of `run` -> 2*run, kMergeTile outputs per
// block.  The split pass finds every block's merge-path split at once, one
// warp per block, each by a 32-way search over the carried tuples (every
// lane probes one diagonal point, a ballot keeps 1/32 of the range: about 5
// rounds of independent loads at 2^22 against 21 dependent ones).  The merge
// block then stages its A and B slices in shared memory with cp.async (all
// loads in flight at once, no registers), each thread merges kMergeItems
// outputs from there and stores them straight from registers, 16 bytes at a
// time.  So a level moves 2 * (C+1) * 4 bytes per element, all coalesced
// (168 MB at 2^22 x 4 keys): the merge is bound by that traffic, and no
// block waits on a search before its loads start.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCarry = 4;                                 // MAX_CARRY in ops/sort.py
constexpr int kTileThreads = 1024;
constexpr int kTileItems = 8;
constexpr int kSortTile = kTileThreads * kTileItems;         // 8192; TILE in ops/sort.py
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeBlocks = 3;                              // K2 blocks per SM (launch bound)
constexpr int kMergeTile = kMergeThreads * kMergeItems;      // 2048 outputs per K2 block
constexpr int kPartitionThreads = 256;                       // 8 splits per split-pass block
constexpr int32_t kPadKey = 0x7FFFFFFF;

// Shared-memory rows keep one spare slot per 16 (K1 slots) or word per 32
// (K2 rows), so a warp writing per-thread runs of consecutive elements hits
// distinct banks.
constexpr int kSlotRow = kSortTile + kSortTile / 16;
constexpr int kMergeRow = kMergeTile + kMergeTile / 32;
__device__ __forceinline__ int sp16(int i) { return i + (i >> 4); }
__device__ __forceinline__ int sp32(int i) { return i + (i >> 5); }

// The (K, n) key matrix: K1 reads its first C rows; both kernels read rows
// C..K-1 by index when the carried keys of two elements tie.
struct Keys {
  const int32_t* data;
  int64_t n;
  int K;
};

// (keys C.., index) order of two elements whose carried keys all tie.
template <int C>
__device__ __noinline__ bool rest_less(const Keys& ks, int32_t a, int32_t b) {
  if (a >= ks.n || b >= ks.n) return a < b;  // padding: by index, after every real element
  for (int k = C; k < ks.K; ++k) {
    const int32_t x = __ldg(ks.data + k * ks.n + a);
    const int32_t y = __ldg(ks.data + k * ks.n + b);
    if (x != y) return x < y;
  }
  return a < b;
}

template <int C>
__device__ __forceinline__ bool tail_less(const Keys& ks, int32_t a, int32_t b) {
  return ks.K > C ? rest_less<C>(ks, a, b) : a < b;
}

// dst[0, ITEMS) = f(0) .. f(ITEMS - 1), 16 bytes a store (dst 16-byte
// aligned).
template <int ITEMS, typename F>
__device__ __forceinline__ void stg_row(int32_t* dst, F f) {
  static_assert(ITEMS % 4 == 0, "rows are stored as int4");
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q)
    reinterpret_cast<int4*>(dst)[q] = make_int4(f(4 * q), f(4 * q + 1), f(4 * q + 2), f(4 * q + 3));
}

// Number of A elements among the first `diag` outputs of merge(A, B), A and
// B sorted runs of one shared-memory buffer; less(i, j) compares its
// elements i and j.
template <typename Less>
__device__ __forceinline__ int merge_path(int a0, int na, int b0, int nb, int diag, Less less) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (less(a0 + mid, b0 + diag - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge A[ai, ae) and B[bi, be) of a shared-memory buffer into v, ITEMS
// outputs (past the end of both, v holds don't-care elements); load(i)
// reads element i, less(x, y) compares two loaded elements.
template <typename T, int ITEMS, typename Load, typename Less>
__device__ __forceinline__ void serial_merge(int ai, int ae, int bi, int be, T (&v)[ITEMS],
                                             Load load, Less less) {
  T a = {}, b = {};
  if (ai < ae) a = load(ai);
  if (bi < be) b = load(bi);
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const bool take_a = bi >= be || (ai < ae && less(a, b));
    v[t] = take_a ? a : b;
    if (take_a) {
      if (++ai < ae) a = load(ai);
    } else {
      if (++bi < be) b = load(bi);
    }
  }
}

// ------------------------------------------------------------------ K1

// A K1 element: key 0 and the position in the tile.
using Slot = int2;

// Slot order: key 0, then keys 1..C-1 of the tile by position, then the
// rest of the tuple order by element index (tile start + position).
template <int C>
struct SlotLess {
  const int32_t* rest;  // keys 1..C-1 of the tile, (C-1, kSortTile), tile order
  int32_t base;         // index of the tile's first element
  Keys ks;

  __device__ __forceinline__ bool operator()(Slot a, Slot b) const {
    if (a.x != b.x) return a.x < b.x;
#pragma unroll
    for (int c = 1; c < C; ++c) {
      const int32_t x = rest[(c - 1) * kSortTile + a.y], y = rest[(c - 1) * kSortTile + b.y];
      if (x != y) return x < y;
    }
    return tail_less<C>(ks, base + a.y, base + b.y);
  }
};

// v sorted in registers: a bitonic network, every index known at compile
// time once the loops unroll.
template <int ITEMS, typename T, typename Less>
__device__ __forceinline__ void sort_registers(T (&v)[ITEMS], Less less) {
  static_assert((ITEMS & (ITEMS - 1)) == 0, "a bitonic network needs a power of two");
#pragma unroll
  for (int k = 2; k <= ITEMS; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & k) == 0;
          const bool swap = less(v[l], v[i]) == up;
          const T lo = swap ? v[l] : v[i];
          v[l] = swap ? v[i] : v[l];
          v[i] = lo;
        }
      }
    }
  }
}

// K1: one block per kSortTile tile; out (C+1, n_pad) gets each tile's tuples
// sorted.  Dynamic shared memory: keys 1..C-1 (C-1 rows of kSortTile), then
// kSlotRow slots.
template <int C>
__global__ void __launch_bounds__(kTileThreads)
sort_tiles_kernel(Keys ks, int32_t* __restrict__ out, int64_t n_pad) {
  extern __shared__ int4 smem4[];
  int32_t* rest = reinterpret_cast<int32_t*>(smem4);
  Slot* slots = reinterpret_cast<Slot*>(rest + (C - 1) * kSortTile);
  const int64_t base = (int64_t)blockIdx.x * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += kTileThreads) {
    const int64_t g = base + i;
#pragma unroll
    for (int c = 1; c < C; ++c)
      rest[(c - 1) * kSortTile + i] = g < ks.n ? __ldg(ks.data + c * ks.n + g) : kPadKey;
  }
  const int first = threadIdx.x * kTileItems;
  Slot v[kTileItems];
#pragma unroll
  for (int t = 0; t < kTileItems; ++t) {
    const int64_t g = base + first + t;
    v[t] = make_int2(g < ks.n ? __ldg(ks.data + g) : kPadKey, first + t);
  }
  __syncthreads();
  const SlotLess<C> less{rest, (int32_t)base, ks};
  sort_registers<kTileItems>(v, less);

  const auto load = [&](int i) { return slots[sp16(i)]; };
  for (int w = kTileItems; w < kSortTile; w *= 2) {  // runs of w -> 2w
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTileItems; ++t) slots[sp16(first + t)] = v[t];
    __syncthreads();
    const int g0 = first & ~(2 * w - 1);
    const int d = first - g0;
    const int a = merge_path(g0, w, g0 + w, w, d,
                             [&](int i, int j) { return less(load(i), load(j)); });
    serial_merge(g0 + a, g0 + w, g0 + w + d - a, g0 + 2 * w, v, load, less);
  }
  int32_t* o = out + base + first;
  stg_row<kTileItems>(o, [&](int t) { return v[t].x; });
#pragma unroll
  for (int c = 1; c < C; ++c)
    stg_row<kTileItems>(o + c * n_pad, [&](int t) { return rest[(c - 1) * kSortTile + v[t].y]; });
  stg_row<kTileItems>(o + C * n_pad, [&](int t) { return (int32_t)base + v[t].y; });
}

// ------------------------------------------------------------------ K2

template <int C>
struct Tup {
  int32_t k[C];
  int32_t idx;
};

// Row c of a tuple: key c, or the index for c == C.
template <int C>
__device__ __forceinline__ int32_t field(const Tup<C>& t, int c) {
  return c == C ? t.idx : t.k[c < C ? c : 0];
}

template <int C>
__device__ __forceinline__ bool tup_less(const Tup<C>& a, const Tup<C>& b, const Keys& ks) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (a.k[c] != b.k[c]) return a.k[c] < b.k[c];
  return tail_less<C>(ks, a.idx, b.idx);
}

// Tuple i of the merge block's shared-memory rows.
template <int C>
__device__ __forceinline__ Tup<C> lds_tup(const int32_t* s, int i) {
  const int p = sp32(i);
  Tup<C> t;
#pragma unroll
  for (int c = 0; c < C; ++c) t.k[c] = s[c * kMergeRow + p];
  t.idx = s[C * kMergeRow + p];
  return t;
}

// Shared-memory tuples i < j, a key at a time: a comparison decided by key 0
// reads two words.
template <int C>
__device__ __forceinline__ bool less_at(const int32_t* s, int i, int j, const Keys& ks) {
  const int pi = sp32(i), pj = sp32(j);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t x = s[c * kMergeRow + pi], y = s[c * kMergeRow + pj];
    if (x != y) return x < y;
  }
  return tail_less<C>(ks, s[C * kMergeRow + pi], s[C * kMergeRow + pj]);
}

// The same for tuples i and j of a (C+1, n_pad) buffer in device memory.
template <int C>
__device__ __forceinline__ bool less_ldg(const int32_t* in, int64_t n_pad, int64_t i, int64_t j,
                                         const Keys& ks) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t x = __ldg(in + c * n_pad + i), y = __ldg(in + c * n_pad + j);
    if (x != y) return x < y;
  }
  return tail_less<C>(ks, __ldg(in + C * n_pad + i), __ldg(in + C * n_pad + j));
}

// merge_path over device memory, by one warp: each round every lane probes
// one point of [lo, hi) and a ballot keeps the 1/32 of the range that holds
// the split.  A = in[a0, a0+na), B = in[b0, b0+nb).
template <int C>
__device__ int warp_merge_path(const int32_t* in, int64_t n_pad, int64_t a0, int na, int64_t b0,
                               int nb, int diag, const Keys& ks) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int m = lo + (int)(((int64_t)(hi - lo) * lane) >> 5);
    const bool p = less_ldg<C>(in, n_pad, a0 + m, b0 + diag - 1 - m, ks);
    const int taken = __popc(__ballot_sync(0xffffffffu, p));  // probes are ascending: a prefix
    const int m_last = __shfl_sync(0xffffffffu, m, (taken + 31) & 31);
    const int m_next = __shfl_sync(0xffffffffu, m, taken & 31);
    if (taken == 0) {
      hi = lo;
    } else {
      lo = m_last + 1;
      if (taken < 32) hi = m_next;
    }
  }
  return lo;
}

// The run pair of K2 block b: its start in the buffer, the lengths of its A
// and B runs, and the block's first output diagonal within the pair.
struct RunPair {
  int64_t base;
  int la, lb, d0;
};

__device__ __forceinline__ RunPair pair_of(int64_t b, int64_t n_pad, int64_t run) {
  const int64_t out0 = b * kMergeTile;
  const int64_t base = out0 / (2 * run) * (2 * run);
  return {base, (int)min(run, n_pad - base),
          (int)max((int64_t)0, min(run, n_pad - base - run)), (int)(out0 - base)};
}

// K2 split pass: splits[b] = the number of A elements among the outputs of
// the run pair before K2 block b's first, one warp per block.
template <int C>
__global__ void __launch_bounds__(kPartitionThreads)
merge_partition_kernel(Keys ks, const int32_t* __restrict__ in, int32_t* __restrict__ splits,
                       int64_t n_pad, int64_t run) {
  const int64_t b = (int64_t)blockIdx.x * (kPartitionThreads / 32) + (threadIdx.x >> 5);
  if (b >= n_pad / kMergeTile) return;  // whole warps only: the search ballots
  const RunPair p = pair_of(b, n_pad, run);
  const int a = warp_merge_path<C>(in, n_pad, p.base, p.la, p.base + p.la, p.lb, p.d0, ks);
  if ((threadIdx.x & 31) == 0) splits[b] = a;
}

// K2 merge: in and out are (C+1, n_pad) tuple buffers; block b merges its
// kMergeTile outputs of the run pair from the splits at its two ends.
template <int C>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocks)
merge_level_kernel(Keys ks, const int32_t* __restrict__ in, const int32_t* __restrict__ splits,
                   int32_t* __restrict__ out, int64_t n_pad, int64_t run) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  const RunPair p = pair_of(blockIdx.x, n_pad, run);
  // a pair's length is a multiple of kMergeTile: every block is full
  const bool last = p.d0 + kMergeTile == p.la + p.lb;
  const int a0 = splits[blockIdx.x];
  const int na = (last ? p.la : splits[blockIdx.x + 1]) - a0;
  const int b0 = p.d0 - a0;
#pragma unroll
  for (int t = 0; t < kMergeItems; ++t) {
    const int i = threadIdx.x + t * kMergeThreads;
    const int64_t g = i < na ? p.base + a0 + i : p.base + p.la + b0 + (i - na);
    const int q = sp32(i);
#pragma unroll
    for (int c = 0; c <= C; ++c) __pipeline_memcpy_async(s + c * kMergeRow + q, in + c * n_pad + g, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int diag = threadIdx.x * kMergeItems;
  const int a = merge_path(0, na, na, kMergeTile - na, diag,
                           [&](int i, int j) { return less_at<C>(s, i, j, ks); });
  Tup<C> v[kMergeItems];
  serial_merge(a, na, na + diag - a, kMergeTile, v, [&](int i) { return lds_tup<C>(s, i); },
               [&](const Tup<C>& x, const Tup<C>& y) { return tup_less<C>(x, y, ks); });
  int32_t* o = out + (int64_t)blockIdx.x * kMergeTile + diag;
#pragma unroll
  for (int c = 0; c <= C; ++c)
    stg_row<kMergeItems>(o + c * n_pad, [&](int t) { return field<C>(v[t], c); });
}

template <int C>
int launch_sort_tiles(const Keys& ks, int32_t* out, int64_t n_pad, cudaStream_t stream) {
  const int bytes = (C - 1) * kSortTile * (int)sizeof(int32_t) + kSlotRow * (int)sizeof(Slot);
  cudaError_t e = cudaFuncSetAttribute(sort_tiles_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  sort_tiles_kernel<C><<<(unsigned)(n_pad / kSortTile), kTileThreads, bytes, stream>>>(ks, out, n_pad);
  return (int)cudaGetLastError();
}

template <int C>
int launch_merge_level(const Keys& ks, const int32_t* in, int32_t* out, int32_t* splits,
                       int64_t n_pad, int64_t run, cudaStream_t stream) {
  const int64_t blocks = n_pad / kMergeTile;
  constexpr int per = kPartitionThreads / 32;
  merge_partition_kernel<C><<<(unsigned)((blocks + per - 1) / per), kPartitionThreads, 0, stream>>>(
      ks, in, splits, n_pad, run);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int bytes = (C + 1) * kMergeRow * (int)sizeof(int32_t);
  e = cudaFuncSetAttribute(merge_level_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  merge_level_kernel<C><<<(unsigned)blocks, kMergeThreads, bytes, stream>>>(ks, in, splits, out,
                                                                            n_pad, run);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ------------------------------------------------------------------ the stage merge
//
// One bitonic merge-split stage of the sharded megablock
// (parallel/megablock.py _merge_split_sort), driven by ops/sort.py
// stage_merge.  For each row b: the low S, or the high S, of the stable merge
// of two runs sorted by K <= kStageMaxKeys int32 keys, A = row b of this
// shard's operands ("mine") and B = row src[b] of the partner's, A first on
// equal keys; at most one payload (4 or 1 bytes an element) rides along.  It
// replaces no TPU kernel: the JAX program re-sorts [mine, partner] with
// lax.sort at every stage.
//
// Bound: each kept element's columns read once and written once, 2 * S *
// (4K + payload bytes) a row: 4.0 GB for a 5-key stage at (8, 12.5M), 1.19 ms
// at 3.35 TB/s.  The K2 form it replaces moved some ten times that (the
// partner's copy, the [mine, partner] concatenation, the key matrix, the
// padded tuple buffer with its index row, the merge of both halves, the
// gather of the keys past the fourth and of the payload, the select).  So
// nothing is built around the merge:
// - stage_split_kernel finds the merge-path split of each output tile of a
//   row, one warp a tile point, by the 32-way ballot search of K2's split
//   pass, reading the key columns straight from the A and B rows, starting
//   at diagonal 0 (keep low) or S (keep high);
// - stage_merge_kernel stages its tile's A and B key slices in shared memory
//   with cp.async, merges there comparing all K keys (no tuple, no index, no
//   key read by index), keeps each output's source slot, then writes every
//   key column from shared memory and the payload from its source row, each
//   a coalesced pass over the tile's outputs.  Only the kept S outputs are
//   computed; the last tile of a row is masked, not padded.
// The source-row map and the operands' row pointers travel by value in the
// launch arguments (StageArgs), so no index tensor is copied to the card.

constexpr int kStageMaxKeys = 5;                      // STAGE_MAX_KEYS in ops/sort.py
constexpr int kStageMaxRows = 256;                    // STAGE_MAX_ROWS in ops/sort.py
constexpr int kStageTile = kMergeTile;                // outputs per merge block
constexpr int kStagePoints = kPartitionThreads / 32;  // split points per split-pass block

struct StageArgs {
  const int32_t* a[kStageMaxKeys];  // mine: key c of row b at a[c] + b * a_stride[c]
  const int32_t* b[kStageMaxKeys];  // the partner: row src[b] at b[c] + src[b] * b_stride[c]
  int32_t* out[kStageMaxKeys];      // (rows, S), contiguous
  int64_t a_stride[kStageMaxKeys];
  int64_t b_stride[kStageMaxKeys];
  const uint8_t* a_pay;             // payload rows, strides in elements
  const uint8_t* b_pay;
  uint8_t* out_pay;
  int64_t a_pay_stride, b_pay_stride;
  int pay_bytes;                    // 0 (no payload), 1 or 4
  const bool* keep_low;             // (rows, 1)
  int32_t* splits;                  // (rows, tiles + 1): A elements before each tile point
  int64_t S;
  int rows, tiles;
  int32_t src[kStageMaxRows];
};

// A <= B on K keys, A's element i and B's element j of a row pair in device memory.
template <int K>
__device__ __forceinline__ bool stage_le_ldg(const int32_t* const (&a)[K], int64_t i,
                                             const int32_t* const (&b)[K], int64_t j) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int32_t x = __ldg(a[c] + i), y = __ldg(b[c] + j);
    if (x != y) return x < y;
  }
  return true;
}

// The first m of [lo, hi) where pred(m) is false, pred true on a prefix, by
// one warp: warp_merge_path's 32-way ballot search for any predicate.
template <typename Pred>
__device__ int warp_partition(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int m = lo + (int)(((int64_t)(hi - lo) * lane) >> 5);
    const int taken = __popc(__ballot_sync(0xffffffffu, pred(m)));
    const int m_last = __shfl_sync(0xffffffffu, m, (taken + 31) & 31);
    const int m_next = __shfl_sync(0xffffffffu, m, taken & 31);
    if (taken == 0) {
      hi = lo;
    } else {
      lo = m_last + 1;
      if (taken < 32) hi = m_next;
    }
  }
  return lo;
}

// Stage split pass: splits[row][k] = the number of A elements among the
// first d outputs of merge(A, B), d = (keep low ? 0 : S) + min(k * kStageTile, S).
template <int K>
__global__ void __launch_bounds__(kPartitionThreads) stage_split_kernel(const StageArgs p) {
  const int points = p.tiles + 1;
  const int64_t w = (int64_t)blockIdx.x * kStagePoints + (threadIdx.x >> 5);
  if (w >= (int64_t)p.rows * points) return;  // whole warps only: the search ballots
  const int row = (int)(w / points);
  const int64_t S = p.S;
  const int diag = (int)((p.keep_low[row] ? 0 : S) + min((int64_t)(w % points) * kStageTile, S));
  const int64_t src = p.src[row];
  const int32_t* a[K];
  const int32_t* b[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    a[c] = p.a[c] + row * p.a_stride[c];
    b[c] = p.b[c] + src * p.b_stride[c];
  }
  // pred(m): A[m] goes before B[diag - 1 - m], so it is among the first diag outputs
  const int split = warp_partition((int)max((int64_t)0, diag - S), (int)min((int64_t)diag, S),
                                   [&](int m) { return stage_le_ldg<K>(a, m, b, diag - 1 - m); });
  if ((threadIdx.x & 31) == 0) p.splits[w] = split;
}

// A stage element in the merge block: its keys and its slot in the staged tile.
template <int K>
struct StageKey {
  int32_t k[K];
  int slot;
};

// Stage merge: block (row, tile) writes the row's outputs [tile * kStageTile,
// + n) from the A slice [a0, a1) and the B slice that the splits at its two
// ends give.  Dynamic shared memory: K key rows of kMergeRow words (slots
// [0, na) the A slice, [na, n) the B slice), then each output's slot.
template <int K>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocks) stage_merge_kernel(const StageArgs p) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  uint16_t* from = reinterpret_cast<uint16_t*>(s + K * kMergeRow);
  const int row = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const int64_t S = p.S;
  const int64_t d0 = (int64_t)tile * kStageTile;  // the tile's first output in the row
  const int n = (int)min((int64_t)kStageTile, S - d0);
  const int32_t* sp = p.splits + (int64_t)row * (p.tiles + 1) + tile;
  const int a0 = sp[0];
  const int na = sp[1] - a0;
  const int64_t b0 = (p.keep_low[row] ? 0 : S) + d0 - a0;  // the B slice's first element
  const int64_t src = p.src[row];
#pragma unroll
  for (int t = 0; t < kMergeItems; ++t) {
    const int i = threadIdx.x + t * kMergeThreads;
    if (i < n) {
      const int q = sp32(i);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int32_t* g = i < na ? p.a[c] + row * p.a_stride[c] + a0 + i
                                  : p.b[c] + src * p.b_stride[c] + b0 + (i - na);
        __pipeline_memcpy_async(s + c * kMergeRow + q, g, 4);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int diag = threadIdx.x * kMergeItems;
  if (diag < n) {
    const auto load = [&](int i) {
      StageKey<K> x;
#pragma unroll
      for (int c = 0; c < K; ++c) x.k[c] = s[c * kMergeRow + sp32(i)];
      x.slot = i;
      return x;
    };
    const auto le = [](const StageKey<K>& x, const StageKey<K>& y) {  // x before y: A first on ties
#pragma unroll
      for (int c = 0; c < K; ++c)
        if (x.k[c] != y.k[c]) return x.k[c] < y.k[c];
      return true;
    };
    const int a = merge_path(0, na, na, n - na, diag, [&](int i, int j) {
      const int pi = sp32(i), pj = sp32(j);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int32_t x = s[c * kMergeRow + pi], y = s[c * kMergeRow + pj];
        if (x != y) return x < y;
      }
      return true;
    });
    StageKey<K> v[kMergeItems];
    serial_merge(a, na, na + diag - a, n, v, load, le);
#pragma unroll
    for (int t = 0; t < kMergeItems; ++t)
      if (diag + t < n) from[diag + t] = (uint16_t)v[t].slot;
  }
  __syncthreads();

  const int64_t o = row * S + d0;
#pragma unroll
  for (int c = 0; c < K; ++c)
    for (int j = threadIdx.x; j < n; j += kMergeThreads)
      p.out[c][o + j] = s[c * kMergeRow + sp32(from[j])];
  if (p.pay_bytes == 0) return;
  const uint8_t* pa = p.a_pay + (row * p.a_pay_stride + a0) * p.pay_bytes;
  const uint8_t* pb = p.b_pay + (src * p.b_pay_stride + b0) * p.pay_bytes;
  for (int j = threadIdx.x; j < n; j += kMergeThreads) {
    const int f = from[j];
    const uint8_t* g = f < na ? pa + f * p.pay_bytes : pb + (f - na) * p.pay_bytes;
    if (p.pay_bytes == 4)
      reinterpret_cast<int32_t*>(p.out_pay)[o + j] = __ldg(reinterpret_cast<const int32_t*>(g));
    else
      p.out_pay[o + j] = __ldg(g);
  }
}

template <int K>
int launch_stage_merge(const StageArgs& p, cudaStream_t stream) {
  const int64_t points = (int64_t)p.rows * (p.tiles + 1);
  stage_split_kernel<K><<<(unsigned)((points + kStagePoints - 1) / kStagePoints),
                          kPartitionThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int bytes = K * kMergeRow * (int)sizeof(int32_t) + kStageTile * (int)sizeof(uint16_t);
  e = cudaFuncSetAttribute(stage_merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  stage_merge_kernel<K><<<(unsigned)((int64_t)p.rows * p.tiles), kMergeThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  keys is the (K, n) matrix, tuple
// buffers are (C+1, n_pad) with C = min(K, kMaxCarry), 16-byte aligned;
// splits is int32 scratch of n_pad / 2048 words.  Each returns
// cudaErrorInvalidValue for shapes the kernels do not take, else the first
// error of the attribute calls and launches (cudaGetLastError() right after
// each); the Python wrapper raises when it is not 0.

extern "C" int archon_sort_tiles(const int32_t* keys, int64_t n, int K, int C, int32_t* out,
                                 int64_t n_pad, void* stream) {
  if (n < 0 || n > n_pad || n_pad % kSortTile != 0 || n_pad <= 0 || C < 1 || C > kMaxCarry ||
      K < C || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const Keys ks{keys, n, K};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_sort_tiles<1>(ks, out, n_pad, st);
    case 2: return launch_sort_tiles<2>(ks, out, n_pad, st);
    case 3: return launch_sort_tiles<3>(ks, out, n_pad, st);
    default: return launch_sort_tiles<4>(ks, out, n_pad, st);
  }
}

extern "C" int archon_merge_level(const int32_t* keys, int64_t n, int K, int C, const int32_t* in,
                                  int32_t* out, int32_t* splits, int64_t n_pad, int64_t run,
                                  void* stream) {
  if (n < 0 || n > n_pad || n_pad <= 0 || n_pad % kMergeTile != 0 || run <= 0 ||
      (2 * run) % kMergeTile != 0 || C < 1 || C > kMaxCarry || K < C || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const Keys ks{keys, n, K};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_merge_level<1>(ks, in, out, splits, n_pad, run, st);
    case 2: return launch_merge_level<2>(ks, in, out, splits, n_pad, run, st);
    case 3: return launch_merge_level<3>(ks, in, out, splits, n_pad, run, st);
    default: return launch_merge_level<4>(ks, in, out, splits, n_pad, run, st);
  }
}

// One merge-split stage (see "the stage merge" above).  a_keys, b_keys and
// out_keys hold K column pointers and a_strides, b_strides their row strides
// (elements; columns contiguous); the payload pointers are null when
// pay_bytes is 0; src holds `rows` partner rows; splits is int32 scratch of
// rows * (ceil(S / 2048) + 1) words.  Host arrays are read before the call
// returns: they travel to the card in the launch arguments.
extern "C" int archon_stage_merge(const int32_t* const* a_keys, const int64_t* a_strides,
                                  const int32_t* const* b_keys, const int64_t* b_strides,
                                  int32_t* const* out_keys, int K, const void* a_pay,
                                  int64_t a_pay_stride, const void* b_pay, int64_t b_pay_stride,
                                  void* out_pay, int pay_bytes, const int32_t* src, int rows,
                                  int64_t S, const bool* keep_low, int32_t* splits, void* stream) {
  if (K < 1 || K > kStageMaxKeys || rows < 1 || rows > kStageMaxRows || S < 1 ||
      S >= (int64_t{1} << 30) || (pay_bytes != 0 && pay_bytes != 1 && pay_bytes != 4))
    return (int)cudaErrorInvalidValue;
  StageArgs p = {};
  for (int c = 0; c < K; ++c) {
    p.a[c] = a_keys[c];
    p.b[c] = b_keys[c];
    p.out[c] = out_keys[c];
    p.a_stride[c] = a_strides[c];
    p.b_stride[c] = b_strides[c];
  }
  p.a_pay = static_cast<const uint8_t*>(a_pay);
  p.b_pay = static_cast<const uint8_t*>(b_pay);
  p.out_pay = static_cast<uint8_t*>(out_pay);
  p.a_pay_stride = a_pay_stride;
  p.b_pay_stride = b_pay_stride;
  p.pay_bytes = pay_bytes;
  p.keep_low = keep_low;
  p.splits = splits;
  p.S = S;
  p.rows = rows;
  p.tiles = (int)((S + kStageTile - 1) / kStageTile);
  for (int r = 0; r < rows; ++r) p.src[r] = src[r];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_stage_merge<1>(p, st);
    case 2: return launch_stage_merge<2>(p, st);
    case 3: return launch_stage_merge<3>(p, st);
    case 4: return launch_stage_merge<4>(p, st);
    default: return launch_stage_merge<5>(p, st);
  }
}
