// Fused GATv1 attention forward over the BCSR tiling, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tests/legacy_bcsr/fused_attention.py::
// _make_kernel (launched by fused_gat_attention_fwd). Same function, on the
// same TiledGraph (legacy_bcsr/tiles.py): chunk c belongs to receiver tile
// I = chunk_row[c] and sender tile J = chunk_col[c]; its slot k holds the
// receiver I*128 + recv_local[k], the sender J*128 + send_local[k] and
// valid[k]. For each head h and receiver i, over the valid slots of i:
//   logit = leaky_relu(f_dst[h, i] + f_src[h, s], alpha)
//   m     = max of logit                   den = sum of exp(logit - m)
//   out[h, i, :] = sum of exp(logit - m) * drop[k] * wh[h, s, :] / den
// and 0 where i has no valid slot (den = 0). drop is the dropout keep
// factor per slot (null: 1), which scales the aggregated numerators but
// not the denominator. The kernel also writes m (0 where den = 0) and den
// [H, N_pad] for the backward.
//
// The TPU kernel walks the chunks in order on one core, carrying online
// (max, denominator, sum) accumulators of the current row tile from one
// grid step to the next, and builds every gather and scatter from one-hot
// MXU matmuls (heads folded into the lane axis, F padded), because Mosaic
// cannot gather rows. Here:
//   * one block owns one (row tile, head, slab of at most 64 columns) and
//     walks the tile's chunk range [tile_ptr[I], tile_ptr[I + 1]), which is
//     contiguous because chunk_row is sorted. No other block writes its
//     outputs, so there are no global atomics, and the blocks of one tile
//     are adjacent in the grid, so they share the slot data in L2;
//   * two passes over the range: the receivers' max (shared-memory atomic
//     max, on the float's bits), then exp, denominators and the weighted
//     rows of wh, gathered natively and added into a [128, cols] shared
//     accumulator with shared atomics (slots in a chunk are sorted by
//     sender, not receiver). The second pass takes 256 slots at a time and
//     packs the batch's live slots first, so the row scatter spends no
//     thread on a dead or dropped slot;
//   * invalid slots are skipped before the exp;
//   * any F: blocks of columns [64 s, 64 s + 64) each recompute the
//     softmax of their head (F = 256 takes 4 blocks per head).
// Atomics make the summation order vary from run to run at f32 rounding.
//
// Bound on the H100: bytes. It must read f_dst, f_src and wh once, the slot
// data (recv_local, send_local, valid, drop) of the valid slots, and write
// out, m and den; the FLOPs are about 2 F + 10 per valid slot and head.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;      // node rows per tile
constexpr int EC = 128;        // slots per chunk (EDGE_CHUNK)
constexpr int THREADS = 256;   // threads per block, and slots per batch
constexpr int SLAB = 64;       // output columns per block
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float leaky(float x, float alpha) {
  return x >= 0.f ? x : alpha * x;
}

// Atomic max of a float in shared memory by its bits: non-negative floats
// order as signed ints, negative ones in reverse as unsigned ints. The sign
// bit decides, so -0.0 takes the unsigned path (as a signed int it would
// lose to -inf).
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void __launch_bounds__(THREADS)
bcsr_attention_kernel(const float* __restrict__ f_dst,
                      const float* __restrict__ f_src,
                      const float* __restrict__ wh,
                      const int* __restrict__ chunk_col,
                      const int* __restrict__ recv_local,
                      const int* __restrict__ send_local,
                      const float* __restrict__ valid,
                      const float* __restrict__ drop,
                      const int* __restrict__ tile_ptr, int n_tiles, int H,
                      int F, int n_slabs, float alpha,
                      float* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ den_out) {
  __shared__ float s_acc[TILE * SLAB];
  __shared__ float s_m[TILE];
  __shared__ float s_den[TILE];
  __shared__ float s_w[THREADS];  // a batch's live slots, packed first
  __shared__ int s_loc[THREADS];
  __shared__ int s_src[THREADS];
  __shared__ int s_warp[WARPS];

  const int slab = blockIdx.x % n_slabs;
  const int th = blockIdx.x / n_slabs;
  const int h = th % H;
  const int tile = th / H;
  const int c0 = slab * SLAB;
  const int cols = min(SLAB, F - c0);
  const long long n_pad = static_cast<long long>(n_tiles) * TILE;
  const long long k0 = static_cast<long long>(tile_ptr[tile]) * EC;
  const long long k1 = static_cast<long long>(tile_ptr[tile + 1]) * EC;
  const float* fd = f_dst + h * n_pad + static_cast<long long>(tile) * TILE;
  const float* fs = f_src + h * n_pad;
  const float* wh_h = wh + h * n_pad * F + c0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < TILE * cols; i += THREADS) s_acc[i] = 0.f;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    s_m[i] = -__int_as_float(0x7f800000);  // -inf
    s_den[i] = 0.f;
  }
  __syncthreads();

  // pass 1: each receiver's max logit over its valid slots
  for (long long k = k0 + threadIdx.x; k < k1; k += THREADS) {
    if (!(valid[k] > 0.f)) continue;
    const int r = recv_local[k];
    const long long s =
        static_cast<long long>(chunk_col[k / EC]) * TILE + send_local[k];
    atomic_max_float(&s_m[r], leaky(fd[r] + fs[s], alpha));
  }
  __syncthreads();

  // pass 2: exp, denominators, and the weighted rows, 256 slots at a time
  for (long long base = k0; base < k1; base += THREADS) {
    const long long k = base + threadIdx.x;
    bool live = false;
    float w = 0.f;
    int r = 0, s = 0;
    if (k < k1 && valid[k] > 0.f) {
      r = recv_local[k];
      s = chunk_col[k / EC] * TILE + send_local[k];
      const float num = expf(leaky(fd[r] + fs[s], alpha) - s_m[r]);
      atomicAdd(&s_den[r], num);
      w = drop == nullptr ? num : num * drop[k];
      live = w != 0.f;
    }
    // pack the live slots: warp ballots, then the warps' offsets
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_live = 0;
    for (int j = 0; j < WARPS; ++j) {
      offset += j < warp ? s_warp[j] : 0;
      n_live += s_warp[j];
    }
    if (live) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      s_w[pos] = w;
      s_loc[pos] = r;
      s_src[pos] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_live * cols; i += THREADS) {
      const int j = i / cols;
      const int c = i - j * cols;
      atomicAdd(&s_acc[s_loc[j] * cols + c],
                s_w[j] * wh_h[static_cast<long long>(s_src[j]) * F + c]);
    }
    __syncthreads();
  }

  // the tile's rows: out = acc / den, 0 where no slot is valid
  float* out_h = out + (h * n_pad + static_cast<long long>(tile) * TILE) * F + c0;
  for (int i = threadIdx.x; i < TILE * cols; i += THREADS) {
    const int r = i / cols;
    const int c = i - r * cols;
    const float d = s_den[r];
    out_h[static_cast<long long>(r) * F + c] = d > 0.f ? s_acc[i] / d : 0.f;
  }
  if (slab == 0) {
    const long long row0 = h * n_pad + static_cast<long long>(tile) * TILE;
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      const float d = s_den[r];
      m_out[row0 + r] = d > 0.f ? s_m[r] : 0.f;
      den_out[row0 + r] = d;
    }
  }
}

}  // namespace

// f_dst / f_src [H, n_tiles * 128], wh [H, n_tiles * 128, F] f32;
// chunk_col [C] int32; recv_local / send_local [C * 128] int32; valid and
// drop [C * 128] f32 (drop may be null: no dropout); tile_ptr [n_tiles + 1]
// int32, the chunk offsets of each row tile; out [H, n_tiles * 128, F], m
// and den [H, n_tiles * 128] f32, every element written. Launches on
// `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for F < 1 or a grid past 2^31 - 1 blocks).
extern "C" int pygat_bcsr_attention(const float* f_dst, const float* f_src,
                                    const float* wh, const int* chunk_col,
                                    const int* recv_local,
                                    const int* send_local, const float* valid,
                                    const float* drop, const int* tile_ptr,
                                    int n_tiles, int H, int F, float alpha,
                                    float* out, float* m, float* den,
                                    void* stream) {
  if (n_tiles <= 0 || H <= 0) return 0;
  if (F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slabs = (F + SLAB - 1) / SLAB;
  const long long blocks = static_cast<long long>(n_tiles) * H * n_slabs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcsr_attention_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      f_dst, f_src, wh, chunk_col, recv_local, send_local, valid, drop,
      tile_ptr, n_tiles, H, F, n_slabs, alpha, out, m, den);
  return static_cast<int>(cudaGetLastError());
}
