// Banded sender sum for Hopper (sm_90a): per-sender segment sum of edge
// data in banded slot order.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_sender_sum_kernel (launched by _banded_sender_sum_direct). Same
// function: out[n, :] = sum of data[k, :] over the live slots k whose
// sender band[k / 256] * 128 + s_loc[k] is n; dead slots (s_loc == w * 128)
// add nothing, and rows that no live slot names are 0. The banded backward
// uses it for dwh (GATv1, L = HF) and [dwhj | dwhi_msg] (GATv2, L = 2 HF).
//
// The TPU kernel walks the chunks in band-sorted order (the plan's bs_band,
// bs_chunk and bs_sloc), scatters each chunk onto its w-tile window with w
// one-hot matmuls and accumulates in w band-indexed output arrays folded at
// the end, so that every VMEM accumulator advances monotonically. This
// kernel ignores the bs_* schedule and walks the banded chunks directly,
// all in parallel, one thread block per chunk (and per 64 columns), as
// csrc/stream_scatter.cu walks a stream, turned to the sender side:
//   * the block stages the chunk's s_loc and copies its live data rows
//     into a [256, cols] shared window with coalesced loads, several in
//     flight per thread;
//   * within a chunk the live slots are sorted by sender (the plan sorts
//     each receiver tile's edges by sender), so threads form groups of
//     `cols` (one thread per column), each group walks a contiguous slice
//     of the window, sums runs of equal s_loc in a register and adds each
//     run into the output with one global atomic;
//   * the entry point zeroes the output first.
// Accumulation is plain f32; the atomics make the summation order vary from
// run to run. On a clustered graph the runs are short (a tile's senders
// spread over some 2k rows), so the atomics are close to one per live
// slot and column.
//
// Bound on the H100: bytes: [E_b, L] floats read once (live slots), the
// index words, [N_pad, L] floats written; the adds are negligible.

#include "slot_rows.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_SLAB = 64;  // columns per block
constexpr int UNROLL = 8;     // independent window loads per thread

__global__ void __launch_bounds__(THREADS)
banded_sender_sum_kernel(const float* __restrict__ data, WindowRows senders,
                         int L, float* __restrict__ out) {
  extern __shared__ float win[];  // [EC, cols]: the chunk's data rows
  __shared__ int s_row[EC];       // sender row per slot, -1 when dead

  const long long base = static_cast<long long>(blockIdx.x) * EC;
  const int c0 = blockIdx.y * MAX_SLAB;
  const int cols = min(MAX_SLAB, L - c0);
  if (threadIdx.x < EC)
    s_row[threadIdx.x] = senders(base + threadIdx.x, blockIdx.x);
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < EC * cols; i0 += THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      v[u] = 0.f;
      if (i < EC * cols) {
        const int k = i / cols;
        if (s_row[k] >= 0)
          v[u] = __ldg(data + (base + k) * L + c0 + (i - k * cols));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < EC * cols) win[i] = v[u];
    }
  }
  __syncthreads();

  const int groups = THREADS / cols;
  const int grp = threadIdx.x / cols;
  const int col = threadIdx.x - grp * cols;
  if (grp < groups) {
    const int per = (EC + groups - 1) / groups;
    const int k0 = grp * per;
    const int k1 = min(k0 + per, EC);
    int cur = -1;
    float sum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int row = s_row[k];
      if (row < 0) continue;  // dead slot
      if (row != cur) {
        if (cur >= 0)
          atomicAdd(out + static_cast<long long>(cur) * L + c0 + col, sum);
        cur = row;
        sum = 0.f;
      }
      sum += win[k * cols + col];
    }
    if (cur >= 0)
      atomicAdd(out + static_cast<long long>(cur) * L + c0 + col, sum);
  }
}

}  // namespace

// data [n_chunks * 256, L] f32 in banded order; band [n_chunks] int32;
// s_loc [n_chunks * 256] int32; out [n_tiles * 128, L] f32. Zeroes out and
// launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch.
extern "C" int pygat_banded_sender_sum(const float* data, const int* band,
                                       const int* s_loc, int n_chunks,
                                       int n_tiles, int w, int L, float* out,
                                       void* stream) {
  if (n_tiles <= 0 || L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(n_tiles) * TILE * L, st);
  if (e != cudaSuccess || n_chunks <= 0) return static_cast<int>(e);
  const int slab = L < MAX_SLAB ? L : MAX_SLAB;
  const size_t smem = sizeof(float) * EC * slab;
  // above 48 KB of shared memory, s_row's included, a kernel must opt in.
  // The attribute is set on the current device only, so it is set at every
  // such launch (a host-side call of about a microsecond).
  if (smem + sizeof(int) * EC > 48 * 1024) {
    e = cudaFuncSetAttribute(banded_sender_sum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_chunks, (L + MAX_SLAB - 1) / MAX_SLAB);
  banded_sender_sum_kernel<<<grid, THREADS, smem, st>>>(
      data, WindowRows{band, s_loc, w * TILE}, L, out);
  return static_cast<int>(cudaGetLastError());
}
