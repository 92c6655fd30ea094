// In-place read-modify-write of whole 128-float table rows, sm_90a.
//
// Replaces the TPU kernel K7, rmw_kernel (experiments/pallas_tile_rmw.py:29,
// called by rmw at :55): table[tiles[i], :] += deltas[i, :] for N jobs whose
// rows are sorted and unique, on a (T, 128) float32 table updated in place
// (the TPU kernel aliases the table to its output).  The wrapper is
// shine_mapping_tpu_torch/ops/tile_rmw.py; its plain version is
// table.index_add_(0, tiles, deltas).
//
// Design.  One warp per job, eight jobs a CTA: each lane reads 16 bytes of
// the delta and of the table row, adds, and writes the row back, so a job
// is one coalesced 512-byte read, read and write.  The TPU kernel's 16-deep
// DMA pipeline through VMEM has no counterpart: the card keeps thousands of
// such loads in flight across its SMs.  A row outside [0, T) is skipped.
// Rows must be unique (as the TPU kernel assumes): two jobs on one row race.
//
// Bound.  Memory bandwidth: the job rows (4 B), the deltas (512 B), and the
// table rows they touch read and written once (1,024 B) per job: 50.5 MB at
// N = 32,768, 0.015 ms at 3.35 TB/s.  One add per element.

#include <cuda_runtime.h>

#define THREADS 256
#define JOBS_PER_CTA (THREADS / 32)

__global__ void __launch_bounds__(THREADS) tile_rmw_kernel(
    float* table, const int* __restrict__ tiles, const float* __restrict__ deltas,
    int n, long long n_rows) {
  const long long job = (long long)blockIdx.x * JOBS_PER_CTA + (threadIdx.x >> 5);
  if (job >= n) return;
  const long long row = tiles[job];
  if (row < 0 || row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float4* dst = reinterpret_cast<float4*>(table + row * 128) + lane;
  const float4 d = reinterpret_cast<const float4*>(deltas + job * 128)[lane];
  float4 x = *dst;
  x.x += d.x;
  x.y += d.y;
  x.z += d.z;
  x.w += d.w;
  *dst = x;
}

extern "C" {

// Launches the update on `stream`; returns cudaGetLastError() (0 = launched).
int tile_rmw(void* table, const void* tiles, const void* deltas, int n,
             long long n_rows, void* stream) {
  if (n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + JOBS_PER_CTA - 1) / JOBS_PER_CTA);
    tile_rmw_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<float*>(table), static_cast<const int*>(tiles),
        static_cast<const float*>(deltas), n, n_rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
