// The feature update's entry prep, sm_90a: gradient entries binned by the
// update kernel's tile (csrc/fused_adam.cu), in three launches.
//
// Replaces the live prep of shine_mapping_tpu_torch/ops/adam_kernel.py (a
// chain of ~15 torch ops per level, a cat, a stable sort and casts; the JAX
// package's entry_prep_multi, shine_mapping_tpu/ops/adam_kernel.py:307,
// which sorts outside its Pallas kernel).  The wrapper is
// ops/adam_kernel.entry_prep_stack; its plain version (the torch chain, for
// CPU tensors) sorts the entries by row, which is one valid output of this
// contract.
//
// What it computes, for each of W batches (windows) of the same shapes.
// Level l's entries are rows[l] (W, M_l), int32 or int64 (bit l of
// rows64); entry i of a batch is the levels' entries concatenated (level
// l's start at ent_off[l], M = ent_off[L] in all).  Level l's used head [0, n_used[l]) is cut into
// tiles of tb rows (tile_lo[l] is its first tile, T tiles in all).  Entry i
// with row r goes to
//   tile tile_lo[l] + r / tb        if 0 <= r < n_used[l] and r != C_l - 1,
//   the excluded bin T              otherwise (the trashbin row C_l - 1, a
//                                   missed lookup, or a row past the head,
//                                   which is also counted as dropped).
// Outputs, per batch: tile_off (T + 1) -- tile t's entries are positions
// [tile_off[t], tile_off[t + 1]) and the excluded ones follow tile_off[T];
// rows_out (M) -- each position's global row (row_off[l] + r), or the
// sentinel 2^31 - 1 for the excluded; order_out (M) -- each position's
// entry i; dropped (one int64).  Inside a bin the order is the order in
// which the atomics landed (the update sums a tile's entries with atomics,
// so it does not depend on it).
//
// The update's work list (chunk > 0).  A tile of n > chunk entries is
// summed by k = ceil(n / chunk) CTAs of the update kernel, one a chunk of
// its entries: the first is the tile's own CTA (grid index t), the k - 1
// others are "extra" work items.  split_off (T) -- tile t's first extra
// item (the exclusive scan of k - 1 over the tiles; it also keys the
// tile's accumulator slot in the update); split_items (E_max, 2) -- each
// extra item's (tile, chunk j >= 1); n_split (one int32) -- the number of
// extra items, at most M / chunk.  The same scan as tile_off: each tile's
// count and its k - 1 ride one 64-bit value.
//
//   prep_bin_kernel      one thread per entry: its bin and its rank in the bin
//                        (warp-aggregated atomics on the bin counts, the
//                        excluded bin aggregated per block, which most of a
//                        batch's misses share); dropped entries counted per
//                        block
//   prep_scan_kernel     one 1024-thread CTA per batch: exclusive scan of the
//                        bin counts -> tile_off (and the work list);
//                        dropped -> int64
//   prep_scatter_kernel  one thread per entry: position tile_off[bin] + rank
// with one memset of the counts before them: four device ops where the
// torch chain ran ~50.
//
// Bound: bytes.  Each entry's row is read twice and its rank written and
// read once, 8 B written per entry, 8 B per tile and the counts: ~30 B per
// entry.  At the main path's 196,608 entries and 35,860 tiles about 6 MB,
// ~2 us at 3.35 TB/s; the three launches' latency (~3 x 3 us) is the cost.

#include <cuda_runtime.h>

#define MAX_LEVELS 16
#define THREADS 256
#define SCAN_THREADS 1024
#define SENTINEL 0x7fffffff

struct PrepLevels {
  const void* rows[MAX_LEVELS];       // level l's (W, M_l) entry rows
  long long ent_off[MAX_LEVELS + 1];  // first entry of level l; [L] = M
  long long size[MAX_LEVELS];         // C_l (trashbin row C_l - 1)
  long long n_used[MAX_LEVELS];
  long long row_off[MAX_LEVELS];      // first global row of level l
  int tile_lo[MAX_LEVELS];            // first tile of level l
  int n_levels;
  int rows64;                         // bit l: level l's rows are int64
  int tb;                             // rows per tile
};

// entry i of batch w: its bin (a tile, or T) and global row; *drop if its
// row lies past the used head (and is not the trashbin row)
__device__ __forceinline__ int classify(const PrepLevels& a, int w, long long i, int T,
                                        int* grow, bool* drop) {
  int l = 0;
  while (l + 1 < a.n_levels && i >= a.ent_off[l + 1]) ++l;
  const long long M_l = a.ent_off[l + 1] - a.ent_off[l];
  const long long k = (long long)w * M_l + (i - a.ent_off[l]);
  const long long r = (a.rows64 >> l) & 1
                            ? static_cast<const long long*>(a.rows[l])[k]
                            : (long long)static_cast<const int*>(a.rows[l])[k];
  *drop = false;
  *grow = SENTINEL;
  if (r == a.size[l] - 1) return T;
  if (r < 0 || r >= a.n_used[l]) {
    *drop = true;
    return T;
  }
  *grow = (int)(a.row_off[l] + r);
  return a.tile_lo[l] + (int)(r / a.tb);
}

// counts: (W, T + 2) zeroed int32 -- [0, T) the tiles, [T] the excluded
// bin, [T + 1] the dropped count; rank: (W, M)
__global__ void __launch_bounds__(THREADS)
    prep_bin_kernel(PrepLevels a, int M, int T, int* __restrict__ counts, int* __restrict__ rank) {
  __shared__ int s_n, s_base;
  const int w = blockIdx.y;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int* cnt = counts + (long long)w * (T + 2);
  if (threadIdx.x == 0) s_n = 0;
  int b = -1, grow;
  bool drop = false;
  if (i < M) b = classify(a, w, i, T, &grow, &drop);
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int leader = __ffs(peers) - 1;
  const int below = __popc(peers & ((1u << lane) - 1u));
  const int n_drop = __syncthreads_count(drop);  // also orders s_n = 0 first
  int base = 0;
  if (lane == leader && b >= 0) {
    if (b < T)
      base = atomicAdd(&cnt[b], __popc(peers));
    else
      base = atomicAdd(&s_n, __popc(peers));
  }
  base = __shfl_sync(0xffffffffu, base, leader);
  __syncthreads();
  if (threadIdx.x == 0) {
    s_base = s_n ? atomicAdd(&cnt[T], s_n) : 0;
    if (n_drop) atomicAdd(&cnt[T + 1], n_drop);
  }
  __syncthreads();
  if (b == T) base += s_base;
  if (i < M) rank[(long long)w * M + i] = base + below;
}

// tile_off[w] = exclusive scan of counts[w][0, T + 1); dropped[w] =
// counts[w][T + 1]; with chunk > 0 also the work list (split_off, items,
// n_split): each tile's count n (low word) and its extra items k - 1 (high
// word) are scanned as one 64-bit value (sum of n <= M < 2^31, no carry)
__global__ void __launch_bounds__(SCAN_THREADS)
    prep_scan_kernel(const int* __restrict__ counts, int T, int* __restrict__ tile_off,
                     long long* __restrict__ dropped, int chunk, int E_max,
                     int* __restrict__ split_off, int2* __restrict__ split_items,
                     int* __restrict__ n_split) {
  __shared__ unsigned long long s_warp[SCAN_THREADS / 32];
  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* c = counts + (long long)w * (T + 2);
  int* o = tile_off + (long long)w * (T + 1);
  unsigned long long carry = 0;
  for (int start = 0; start < T + 1; start += SCAN_THREADS) {
    const int i = start + threadIdx.x;
    const int n = i < T + 1 ? c[i] : 0;
    const int ex = chunk > 0 && i < T && n > chunk ? (n - 1) / chunk : 0;  // k - 1
    const unsigned long long x = ((unsigned long long)ex << 32) | (unsigned)n;
    unsigned long long s = x;  // inclusive scan in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane == 31) s_warp[warp] = s;
    __syncthreads();
    if (warp == 0) {
      unsigned long long ws = s_warp[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, ws, d);
        if (lane >= d) ws += y;
      }
      s_warp[lane] = ws;
    }
    __syncthreads();
    const unsigned long long e = carry + (warp ? s_warp[warp - 1] : 0ull) + s - x;
    if (i < T + 1) o[i] = (int)(unsigned)e;
    if (chunk > 0 && i < T) {
      const int first = (int)(e >> 32);
      split_off[(long long)w * T + i] = first;
      for (int j = 1; j <= ex && first + j - 1 < E_max; ++j)
        split_items[(long long)w * E_max + first + j - 1] = make_int2(i, j);
    }
    carry += s_warp[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dropped[w] = c[T + 1];
    if (chunk > 0) n_split[w] = (int)(carry >> 32);
  }
}

__global__ void __launch_bounds__(THREADS)
    prep_scatter_kernel(PrepLevels a, int M, int T, const int* __restrict__ tile_off,
                   const int* __restrict__ rank, int* __restrict__ rows_out,
                   int* __restrict__ order_out) {
  const int w = blockIdx.y;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= M) return;
  int grow;
  bool drop;
  const int b = classify(a, w, i, T, &grow, &drop);
  const long long wm = (long long)w * M;
  const long long pos = wm + tile_off[(long long)w * (T + 1) + b] + rank[wm + i];
  rows_out[pos] = grow;
  order_out[pos] = (int)i;
}

extern "C" {

// Launches bin, scan and scatter on `stream`; returns cudaGetLastError()
// (0 = launched).  rows: HOST array of n_levels device pointers;
// ent_off (n_levels + 1), size, n_used, row_off, tile_lo (n_levels): HOST
// arrays.  counts: device (W, T + 2) int32 scratch (zeroed here); rank:
// device (W, M) int32 scratch; tile_off (W, T + 1), rows_out and order_out
// (W, M) int32, dropped (W) int64: device outputs.  chunk > 0: also the
// work list, split_off (W, T), split_items (W, E_max, 2) and n_split (W)
// int32 (device outputs; E_max >= M / chunk); chunk 0 writes none of them.
int entry_prep(const void* const* rows, int rows64, const long long* ent_off, int n_levels,
               const long long* size, const long long* n_used, const long long* row_off,
               const int* tile_lo, int tb, int T, int W, void* counts, void* rank,
               void* tile_off, void* rows_out, void* order_out, void* dropped, void* stream,
               int chunk, int E_max, void* split_off, void* split_items, void* n_split) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || tb < 1 || T < 0 || W < 0 ||
      ent_off[n_levels] > 0x7fffffffLL || W > 65535 || chunk < 0 ||
      (chunk > 0 && (long long)E_max * chunk < ent_off[n_levels]))
    return (int)cudaErrorInvalidValue;
  PrepLevels a;
  for (int l = 0; l < n_levels; ++l) {
    a.rows[l] = rows[l];
    a.ent_off[l] = ent_off[l];
    a.size[l] = size[l];
    a.n_used[l] = n_used[l];
    a.row_off[l] = row_off[l];
    a.tile_lo[l] = tile_lo[l];
  }
  a.ent_off[n_levels] = ent_off[n_levels];
  a.n_levels = n_levels;
  a.rows64 = rows64;
  a.tb = tb;
  const int M = (int)ent_off[n_levels];
  if (W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* cnt = static_cast<int*>(counts);
  int* rk = static_cast<int*>(rank);
  int* to = static_cast<int*>(tile_off);
  const cudaError_t e = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)W * (T + 2), s);
  if (e != cudaSuccess) return (int)e;
  if (M > 0) {
    const dim3 grid((unsigned)((M + THREADS - 1) / THREADS), (unsigned)W);
    prep_bin_kernel<<<grid, THREADS, 0, s>>>(a, M, T, cnt, rk);
  }
  prep_scan_kernel<<<(unsigned)W, SCAN_THREADS, 0, s>>>(
      cnt, T, to, static_cast<long long*>(dropped), chunk, E_max, static_cast<int*>(split_off),
      static_cast<int2*>(split_items), static_cast<int*>(n_split));
  if (M > 0) {
    const dim3 grid((unsigned)((M + THREADS - 1) / THREADS), (unsigned)W);
    prep_scatter_kernel<<<grid, THREADS, 0, s>>>(a, M, T, to, rk, static_cast<int*>(rows_out),
                                            static_cast<int*>(order_out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
