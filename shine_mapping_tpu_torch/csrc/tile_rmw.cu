// In-place read-modify-write of whole 128-float table rows, sm_90a.
//
// Replaces the TPU kernel K7, rmw_kernel (experiments/pallas_tile_rmw.py:29,
// called by rmw at :55): table[tiles[i], :] += deltas[i, :] for N jobs whose
// rows are sorted and unique, on a (T, 128) float32 table updated in place
// (the TPU kernel aliases the table to its output).  The wrapper is
// shine_mapping_tpu_torch/ops/tile_rmw.py; its plain version is
// table.index_add_(0, tiles, deltas).
//
// Design.  A persistent grid (the SMs times the CTAs resident on one,
// computed once per device) walks the jobs in groups of J (GROUP)
// consecutive jobs, a warp a group at a time:
//   - one coalesced load brings the group's J row ids, one a lane, and
//     __shfl_sync hands each to every lane;
//   - every lane then issues the J deltas' and the J table rows' 16-byte
//     loads before it adds any, then adds and stores;
//   - the next group's ids are loaded while this group's rows are in
//     flight, so a group waits on one memory round trip, not two.
// J is 1: the TPU kernel's 16-deep ring of row DMAs has no counterpart,
// because the card keeps rows in flight by warps.  J = 2, 4, 6, 8 take 44,
// 64, 82 and 126 registers a thread against 26, so fewer warps fit an SM,
// and each ran slower with the table in L2 and no faster from DRAM
// (scripts/probe_study_kernels.py).  Deltas are read once, with the
// streaming hint (__ldcs).  A row outside [0, T) is skipped.  Rows must be
// unique (as the TPU kernel assumes): two jobs on one row race.  Each
// element is one float add, so the result is bit-equal to index_add_.
//
// Bound.  Memory bandwidth: the job rows (4 B), the deltas (512 B), and the
// table rows they touch read and written once (1,024 B) per job: 50.5 MB at
// N = 32,768, 0.015 ms at 3.35 TB/s.  One add per element.  That data fits
// the 50 MB L2, so repeated launches beat this bound; a launch that finds
// the L2 cold runs at ~82% of it.

#include <cuda_runtime.h>

#include <mutex>

#define THREADS 256
#define WARPS (THREADS / 32)
#define GROUP 1  // J: the jobs a warp has in flight

__global__ void __launch_bounds__(THREADS) tile_rmw_kernel(
    float* table, const int* __restrict__ tiles, const float* __restrict__ deltas,
    int n, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long n_groups = ((long long)n + GROUP - 1) / GROUP;
  const long long stride = (long long)gridDim.x * WARPS;
  float4* tab = reinterpret_cast<float4*>(table);
  const float4* del = reinterpret_cast<const float4*>(deltas);
  long long grp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  // lane k < GROUP holds the row of job grp GROUP + k (-1 past the last job)
  int id = -1;
  if (grp < n_groups && lane < GROUP && grp * GROUP + lane < n)
    id = __ldcs(tiles + grp * GROUP + lane);
  for (; grp < n_groups; grp += stride) {
    const long long nxt = grp + stride;
    int id_next = -1;
    if (nxt < n_groups && lane < GROUP && nxt * GROUP + lane < n)
      id_next = __ldcs(tiles + nxt * GROUP + lane);
    int row[GROUP];
    float4 d[GROUP], x[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      row[k] = __shfl_sync(0xffffffffu, id, k);
      if (row[k] >= 0 && row[k] < n_rows) {
        d[k] = __ldcs(del + (grp * GROUP + k) * 32 + lane);
        x[k] = tab[(long long)row[k] * 32 + lane];
      }
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      if (row[k] >= 0 && row[k] < n_rows) {
        x[k].x += d[k].x;
        x[k].y += d[k].y;
        x[k].z += d[k].z;
        x[k].w += d[k].w;
        tab[(long long)row[k] * 32 + lane] = x[k];
      }
    }
    id = id_next;
  }
}

// The CTAs of the persistent grid on the current device: the SMs times the
// CTAs resident on one, computed once per device.
static cudaError_t resident_ctas(int* ctas) {
  static std::mutex lock;
  static int dev_cached = -1, ctas_cached = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> guard(lock);
  if (dev != dev_cached) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_rmw_kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    dev_cached = dev;
    ctas_cached = sms * per_sm;
  }
  *ctas = ctas_cached;
  return cudaSuccess;
}

extern "C" {

// Launches the update on `stream`; returns cudaGetLastError() (0 = launched).
int tile_rmw(void* table, const void* tiles, const void* deltas, int n,
             long long n_rows, void* stream) {
  if (n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int ctas = 0;
    const cudaError_t e = resident_ctas(&ctas);
    if (e != cudaSuccess) return (int)e;
    const long long groups = ((long long)n + GROUP - 1) / GROUP;
    const long long need = (groups + WARPS - 1) / WARPS;
    const unsigned blocks = (unsigned)(need < ctas ? need : ctas);
    tile_rmw_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<float*>(table), static_cast<const int*>(tiles),
        static_cast<const float*>(deltas), n, n_rows);
  }
  return (int)cudaGetLastError();
}

// Jobs one pass of the persistent grid covers on the current device (its
// CTAs x warps x GROUP), or 0 on an error.
long long tile_rmw_pass_jobs() {
  int ctas = 0;
  return resident_ctas(&ctas) == cudaSuccess ? (long long)ctas * WARPS * GROUP : 0;
}

}  // extern "C"
