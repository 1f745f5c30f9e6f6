// Fused GATv2 attention forward for Hopper (sm_90a), shared by
// fused_v2.cu (receiver stream order, senders listed per slot) and
// fused_v2_banded.cu (banded order, sender = band[c] * 128 + s_loc[k]).
//
// Same function as the Pallas TPU kernels pygat_tpu/ops/fused_stream.py::
// _make_v2_kernel and pygat_tpu/ops/banded.py::_make_v2_banded_kernel, per
// live slot k of receiver r = tile*128 + local[k] and sender s, for each
// head h:
//   pre[f] = leaky_relu(whi[r, hF+f] + whj[s, hF+f])
//   logit  = sum_f pre[f] * a[h, f]
//   num    = exp(logit - ub[r, h])                    (0 at dead slots)
//   out[r, hF+f] += whi[s, hF+f] * num * keepq[k, h]  (the LEFT projection
//                                                      at the sender)
//   den[r, h]    += num                               (pre-dropout)
//
// The TPU kernels receive whj and whi pre-gathered at the senders in one
// [E, 2HF] window (or select them from the chunk's w-tile VMEM window) and
// build the receiver gather, the a-projection, the head broadcast and the
// scatter from one-hot MXU matmuls, because Mosaic cannot gather rows.
// Here the kernel gathers whj[s] and whi[s] itself. One thread block per
// 256-slot chunk and group of heads (at most 128 columns and 16 heads; one
// head when F > 128), all chunks in parallel, in two phases:
//   1. logits. Unlike GATv1 the logit is a sum over F of a nonlinear term
//      of BOTH ends, so no per-node component can be precomputed. Each
//      (slot, head) item goes to a lane group of P = min(32, pow2 >= F)
//      lanes: lane j forms the terms of features j, j+P, ... and the group
//      reduces them with warp shuffles, so every element of whj[s] is
//      loaded once and an item costs F/P steps, not F (F = 256: 8 steps of
//      coalesced 128-byte loads). A lane group walks a contiguous range of
//      items ordered head-major, slot-minor; the receiver stream is sorted
//      by receiver, so whi[r] and ub[r] are loaded once per run of equal
//      rows and kept in registers, and the run's denominator is summed in a
//      register and added to the shared [128, hb] accumulator with one
//      atomic (in banded order a chunk is sorted by sender, the runs are
//      mostly of length 1, and whi[r] is reloaded from L1 per item). The
//      keep-scaled numerator of every item goes to shared memory. The
//      loop's trip count is the same for every thread and the shuffles
//      sit outside all data-dependent branches, so the full-warp mask is
//      safe;
//   2. messages, as fused_v1.cuh: threads form groups with one thread
//      per (head, feature) column, a group walks a slice of the chunk,
//      multiplies whi[s, col] by the slot's factor and sums runs of equal
//      local rows in a register, adding each run into the f32 [128, cols]
//      shared accumulator with one atomic;
// then the block adds the rows its chunk touched into out and den with
// global atomics; the entry point zeroes both first, so every row is
// written. Atomics make the summation order vary from run to run at f32
// rounding level. Dead slots (local == 128) are skipped before any load or
// exp: their sender is the dummy row N_pad - 1 (or none, in banded order),
// whose content the kernel never reads. No width is assumed to be a
// multiple of 4 or 8 (Cora's layer 2 has H = 1, F = 7, Pubmed's H = 8,
// F = 3): all loads are scalar.
//
// Bound on the H100: bytes from device memory, each input read once and
// each output written once: the node tables whi and whj [N_pad, HF], ub,
// a, H keep factors per live slot, the index words, and out and den. The
// kernel gathers two HF-float rows per live slot (whj[s], whi[s]), but the
// tables stay in L2 at citation sizes (0.72 MB at Cora, 5 MB at Pubmed), so
// those re-reads are L2 traffic and no part of the bound. The FLOPs (about
// 6 HF + 6 H per slot) are negligible. At Cora's shapes the call moves a
// few MB and is launch-bound. At 524k nodes the tables (134 MB each at
// HF = 64) exceed the 50 MB L2; the banded order keeps each chunk's sender
// rows within its w-tile window (w * 128 rows).

#pragma once

#include "slot_rows.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int COL_BUDGET = 128;  // columns per block when F <= 128
constexpr int MAX_HPB = 16;      // heads per block (bounds the factor buffer)
constexpr int MAX_F = 256;
constexpr int MAX_J = MAX_F / 32;  // features per lane at P = 32

template <class Rows>
__global__ void __launch_bounds__(THREADS)
fused_v2_kernel(const float* __restrict__ whi, const float* __restrict__ whj,
                const float* __restrict__ ub, const float* __restrict__ a,
                const float* __restrict__ keepq,
                Rows senders,
                const int* __restrict__ local,
                const int* __restrict__ chunk_tile, int H, int F, int hpb,
                int P, float alpha, float* __restrict__ out,
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
  float* s_a = dacc + TILE * hb;    // [cols]: a of this block's heads
  float* s_q = s_a + cols;          // [EC, hb]: num * keepq per slot, head

  for (int i = threadIdx.x; i < TILE * (cols + hb); i += THREADS) sm[i] = 0.f;
  for (int i = threadIdx.x; i < cols; i += THREADS) s_a[i] = a[h0 * F + i];
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

  // phase 1: one lane group of P lanes per (head, slot) item
  {
    const int lane = threadIdx.x & (P - 1);
    const int n_items = EC * hb;
    const int n_lg = THREADS / P;
    const int per = (n_items + n_lg - 1) / n_lg;
    const int i0 = (threadIdx.x / P) * per;
    const int i1 = min(i0 + per, n_items);
    int cur = -1, cur_hl = -1;
    float wi[MAX_J] = {};  // whi[r] of the current run, this lane's features
    float ub_r = 0.f, dsum = 0.f;
    for (int t = 0; t < per; ++t) {  // the same trip count in every thread
      const int i = i0 + t;
      const bool valid = i < i1;
      const int hl = valid ? i / EC : 0;
      const int k = valid ? i - hl * EC : 0;
      const int loc = valid ? s_loc[k] : TILE;
      const bool live = static_cast<unsigned>(loc) < TILE;
      float part = 0.f;
      if (live) {
        const int hcol = (h0 + hl) * F;
        if (loc != cur || hl != cur_hl) {
          if (cur >= 0 && lane == 0) atomicAdd(&dacc[cur * hb + cur_hl], dsum);
          cur = loc;
          cur_hl = hl;
          dsum = 0.f;
          const float* wr = whi + (row0 + loc) * HF + hcol;
#pragma unroll
          for (int u = 0; u < MAX_J; ++u) {
            const int j = lane + u * P;
            wi[u] = j < F ? __ldg(wr + j) : 0.f;
          }
          ub_r = __ldg(ub + (row0 + loc) * H + h0 + hl);
        }
        const float* wj = whj + static_cast<long long>(s_snd[k]) * HF + hcol;
        const float* a_h = s_a + hl * F;
#pragma unroll
        for (int u = 0; u < MAX_J; ++u) {
          const int j = lane + u * P;
          if (j < F) {
            const float x = wi[u] + __ldg(wj + j);
            part = fmaf(x >= 0.f ? x : alpha * x, a_h[j], part);
          }
        }
      }
      for (int off = P >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (valid && lane == 0) {
        float q = 0.f;
        if (live) {
          const float num = expf(part - ub_r);
          dsum += num;
          q = num * __ldg(keepq + (base + k) * H + h0 + hl);
        }
        s_q[k * hb + hl] = q;
      }
    }
    if (cur >= 0 && lane == 0) atomicAdd(&dacc[cur * hb + cur_hl], dsum);
  }
  __syncthreads();

  // phase 2: one thread per column, runs of equal rows summed in registers
  const int groups = THREADS / cols;
  const int grp = threadIdx.x / cols;
  const int col = threadIdx.x - grp * cols;
  if (grp < groups) {
    const int hl = col / F;
    const int per = (EC + groups - 1) / groups;
    const int k0 = grp * per;
    const int k1 = min(k0 + per, EC);
    int cur = -1;
    float sum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int loc = s_loc[k];
      if (static_cast<unsigned>(loc) >= TILE) continue;  // dead slot
      if (loc != cur) {
        if (cur >= 0) atomicAdd(&acc[cur * cols + col], sum);
        cur = loc;
        sum = 0.f;
      }
      sum = fmaf(__ldg(whi + static_cast<long long>(s_snd[k]) * HF + h0 * F +
                       col),
                 s_q[k * hb + hl], sum);
    }
    if (cur >= 0) atomicAdd(&acc[cur * cols + col], sum);
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

// whi / whj [N, H*F], ub [N, H], a [H, F], keepq [E_s, H] f32;
// senders names each slot's sender row (slot_rows.cuh); local [E_s] int32;
// chunk_tile [n_chunks] int32;
// out [n_tiles * 128, H*F] and den [n_tiles * 128, H] f32. Zeroes out and
// den and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch (cudaErrorInvalidValue when F > 256).
template <class Rows>
int launch_fused_v2(const float* whi, const float* whj, const float* ub,
                    const float* a, const float* keepq, Rows senders,
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
  if (hpb > MAX_HPB) hpb = MAX_HPB;
  if (hpb > H) hpb = H;
  int P = 1;  // lanes per (slot, head) item: a power of two that divides 32
  while (P < F && P < 32) P <<= 1;
  const int cols = hpb * F;
  const size_t smem =
      sizeof(float) * (TILE * (cols + hpb) + cols + EC * hpb);
  // above 48 KB of shared memory a kernel must opt in. The attribute is
  // set on the current device only, so it is set at every such launch
  // (a host-side call of about a microsecond).
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_v2_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_chunks, (H + hpb - 1) / hpb);
  fused_v2_kernel<Rows><<<grid, THREADS, smem, st>>>(
      whi, whj, ub, a, keepq, senders, local, chunk_tile, H, F, hpb, P, alpha,
      out, den);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
