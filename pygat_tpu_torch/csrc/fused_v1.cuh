// Fused GATv1 attention forward for Hopper (sm_90a), shared by
// fused_v1.cu (receiver stream order, senders listed per slot) and
// fused_v1_banded.cu (banded order, sender = band[c] * 128 + s_loc[k]).
//
// Same function as the Pallas TPU kernels pygat_tpu/ops/fused_stream.py::
// _make_v1_kernel and pygat_tpu/ops/banded.py::_make_v1_banded_kernel, per
// live slot k of receiver r = tile*128 + local[k] and sender s, for each
// head h:
//   l_src  = sum_f wh[s, hF+f] * a_src[h, f]
//   raw    = f_dst[r, h] + l_src
//   num    = exp(leaky_relu(raw) - bound[r, h])      (0 at dead slots)
//   out[r, hF+f] += wh[s, hF+f] * num * keepq[k, h]
//   den[r, h]    += num                              (pre-dropout)
//
// The TPU kernels receive the sender rows pre-gathered into an [E, HF]
// window (or select them from the chunk's w-tile VMEM window) and build the
// receiver gather, the head broadcast and the scatter from one-hot MXU
// matmuls, because Mosaic cannot gather rows. Here the kernel gathers wh[s]
// itself and works in registers:
//   * one thread block per 256-slot chunk and group of heads (at most 128
//     columns), all chunks in parallel; the chunk's local rows and sender
//     rows (the `Rows` policy of slot_rows.cuh) are staged in shared
//     memory;
//   * threads form groups with one thread per (head, feature) column; a
//     group walks a slice of the chunk, recomputes its head's logit from
//     the gathered row (the F loads hit L1), and sums runs of equal local
//     rows in registers, adding each run into f32 [128, cols] and [128, hb]
//     shared accumulators with one atomic. In receiver stream order the
//     runs are a row's in-edges; in banded order a chunk is sorted by
//     sender, so the runs are mostly of length 1 and the kernel pays about
//     one shared-memory atomic per live slot and column;
//   * the block adds the rows its chunk touched into out and den with
//     global atomics; the entry point zeroes both first, so every row is
//     written, also in a tile with no live slot. Atomics make the
//     summation order vary from run to run at f32 rounding level;
//   * dead slots (local == 128) are skipped before the exp, the
//     counterpart of the TPU kernel's dead-slot kill: a dead slot's logit
//     is unspecified and its exp could overflow into inf * 0 = NaN.
// No width is assumed to be a multiple of 4 or 8 (Cora's layer 2 has
// H = 1, F = 7).
//
// Bound on the H100: bytes. Per live slot it reads one HF-float row of wh,
// H keep factors and the index words; the FLOPs (about 4 HF per slot) are
// negligible. At citation sizes wh stays in L2 and the call is
// launch-bound; at 524k nodes wh (134 MB at HF = 64) exceeds the 50 MB L2,
// and the banded order keeps each chunk's sender rows within its w-tile
// window (w * 128 rows), so consecutive slots re-read rows from L2.

#pragma once

#include "slot_rows.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int COL_BUDGET = 128;  // columns per block when F <= 128
constexpr int MAX_F = 256;

template <class Rows>
__global__ void __launch_bounds__(THREADS)
fused_v1_kernel(const float* __restrict__ wh, const float* __restrict__ f_dst,
                const float* __restrict__ bound,
                const float* __restrict__ a_src,
                const float* __restrict__ keepq,
                Rows senders,
                const int* __restrict__ local,
                const int* __restrict__ chunk_tile, int H, int F, int hpb,
                float alpha, float* __restrict__ out,
                float* __restrict__ den) {
  extern __shared__ float sm[];
  __shared__ int s_loc[EC];
  __shared__ int s_snd[EC];
  __shared__ int s_lo, s_hi;  // range of local rows this chunk touches

  const long long base = static_cast<long long>(blockIdx.x) * EC;
  const long long row0 =
      static_cast<long long>(chunk_tile[blockIdx.x]) * TILE;
  const int h0 = blockIdx.y * hpb;
  const int hb = min(hpb, H - h0);
  const int cols = hb * F;
  const int HF = H * F;
  float* acc = sm;                  // [TILE, cols]
  float* dacc = acc + TILE * cols;  // [TILE, hb]
  float* s_a = dacc + TILE * hb;    // [cols]: a_src of this block's heads

  for (int i = threadIdx.x; i < TILE * (cols + hb); i += THREADS) sm[i] = 0.f;
  for (int i = threadIdx.x; i < cols; i += THREADS) s_a[i] = a_src[h0 * F + i];
  if (threadIdx.x == 0) {
    s_lo = TILE;
    s_hi = -1;
  }
  if (threadIdx.x < EC) {
    s_loc[threadIdx.x] = local[base + threadIdx.x];
    s_snd[threadIdx.x] = senders(base + threadIdx.x, blockIdx.x);
  }
  __syncthreads();
  if (threadIdx.x < EC && static_cast<unsigned>(s_loc[threadIdx.x]) < TILE) {
    atomicMin(&s_lo, s_loc[threadIdx.x]);
    atomicMax(&s_hi, s_loc[threadIdx.x]);
  }

  const int groups = THREADS / cols;
  const int grp = threadIdx.x / cols;
  const int col = threadIdx.x - grp * cols;
  if (grp < groups) {
    const int hl = col / F;
    const int f = col - hl * F;
    const int h = h0 + hl;
    const bool lead = f == 0;  // one thread per head adds the denominator
    const int per = (EC + groups - 1) / groups;
    const int k0 = grp * per;
    const int k1 = min(k0 + per, EC);
    const float* a_h = s_a + hl * F;
    int cur = -1;
    float sum = 0.f, dsum = 0.f, fd = 0.f, bd = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int loc = s_loc[k];
      if (static_cast<unsigned>(loc) >= TILE) continue;  // dead slot
      if (loc != cur) {
        if (cur >= 0) {
          atomicAdd(&acc[cur * cols + col], sum);
          if (lead) atomicAdd(&dacc[cur * hb + hl], dsum);
        }
        cur = loc;
        sum = 0.f;
        dsum = 0.f;
        fd = __ldg(f_dst + (row0 + loc) * H + h);
        bd = __ldg(bound + (row0 + loc) * H + h);
      }
      const float* w = wh + static_cast<long long>(s_snd[k]) * HF + h * F;
      float l_src = 0.f;
      for (int j = 0; j < F; ++j) l_src = fmaf(__ldg(w + j), a_h[j], l_src);
      const float raw = fd + l_src;
      const float logit = raw >= 0.f ? raw : alpha * raw;
      const float num = expf(logit - bd);
      const float q = num * __ldg(keepq + (base + k) * H + h);
      sum = fmaf(__ldg(w + f), q, sum);
      dsum += num;
    }
    if (cur >= 0) {
      atomicAdd(&acc[cur * cols + col], sum);
      if (lead) atomicAdd(&dacc[cur * hb + hl], dsum);
    }
  }
  __syncthreads();

  for (int i = s_lo * cols + threadIdx.x; i < (s_hi + 1) * cols; i += THREADS) {
    const int r = i / cols;
    atomicAdd(&out[(row0 + r) * HF + h0 * F + (i - r * cols)], acc[i]);
  }
  for (int i = s_lo * hb + threadIdx.x; i < (s_hi + 1) * hb; i += THREADS) {
    const int r = i / hb;
    atomicAdd(&den[(row0 + r) * H + h0 + (i - r * hb)], dacc[i]);
  }
}

// wh [N, H*F], f_dst / bound [N, H], a_src [H, F], keepq [E_s, H] f32;
// senders names each slot's sender row (slot_rows.cuh); local [E_s] int32;
// chunk_tile [n_chunks] int32;
// out [n_tiles * 128, H*F] and den [n_tiles * 128, H] f32. Zeroes out and
// den and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch (cudaErrorInvalidValue when F > 256).
template <class Rows>
int launch_fused_v1(const float* wh, const float* f_dst, const float* bound,
                    const float* a_src, const float* keepq, Rows senders,
                    const int* local, const int* chunk_tile, int n_chunks,
                    int n_tiles, int H, int F, float alpha, float* out,
                    float* den, void* stream) {
  if (n_tiles <= 0 || H <= 0) return 0;
  if (F <= 0 || F > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(n_tiles) * TILE;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * rows * H * F, st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(den, 0, sizeof(float) * rows * H, st);
  if (e != cudaSuccess || n_chunks <= 0) return static_cast<int>(e);
  int hpb = COL_BUDGET / F;
  if (hpb < 1) hpb = 1;
  if (hpb > H) hpb = H;
  const int cols = hpb * F;
  const size_t smem = sizeof(float) * (TILE * (cols + hpb) + cols);
  // above 48 KB of shared memory a kernel must opt in. The attribute is
  // set on the current device only, so it is set at every such launch
  // (a host-side call of about a microsecond).
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_v1_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_chunks, (H + hpb - 1) / hpb);
  fused_v1_kernel<Rows><<<grid, THREADS, smem, st>>>(
      wh, f_dst, bound, a_src, keepq, senders, local, chunk_tile, H, F, hpb,
      alpha, out, den);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
