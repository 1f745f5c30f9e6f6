// Tile-owner fused GATv1/GATv2 attention forwards for Hopper (sm_90a),
// shared by the kernels of three edge orders: the receiver stream
// (fused_v1.cu, fused_v2.cu), the corner path's sender windows over that
// stream (fused_v1_window.cu, fused_v2_window.cu) and a band plan
// (fused_v1_banded.cu, fused_v2_banded.cu).
//
// Same function as the Pallas TPU kernels pygat_tpu/ops/fused_stream.py::
// _make_v1_kernel and _make_v2_kernel (and their banded forms
// pygat_tpu/ops/banded.py::_make_v1_banded_kernel, _make_v2_banded_kernel),
// per live slot k of receiver r and sender s, for each head h:
//   v1: l_src = sum_f wh[s, hF+f] * a[h, f]
//       num   = exp(leaky_relu(f_dst[r, h] + l_src) - bound[r, h])
//   v2: num   = exp(sum_f leaky_relu(whi[r, hF+f] + whj[s, hF+f]) * a[h, f]
//                   - ub[r, h])
//   both: out[r, hF+f] += row(s)[hF+f] * num * keepq[k, h]
//         den[r, h]    += num                      (pre-dropout)
// where row(s) is wh[s] (v1) or whi[s], the LEFT projection at the sender
// (v2). Dead slots read nothing and add nothing; their logits are never
// formed.
//
// The kernel walks each tile's slots with receivers ascending, so the
// slots of one receiver are one contiguous run of positions, and row_ptr
// gives the run of every (tile, local row) key t * 129 + l (a tile's dead
// slots sort last, at key t * 129 + 128, and are never read). By position
// a walk policy names the slot's sender-side row and its row of keepq:
//   * BandWalk: a band plan's walk (BandPlan.spmm_walk, built on the card at
//     the plan's first use), the sender row rows[k] and the banded slot
//     order[k], by which keepq is read;
//   * ListWalk: the receiver stream, which is tile-major and
//     receiver-sorted with its padding at each tile's end, so it is its own
//     walk (Graph.stream_walk: row_ptr from the host once per graph); the
//     sender row senders[k], keepq row k;
//   * SlotWalk: the same stream over the corner path's window, which holds
//     slot k's sender-side row in its row k: row k, keepq row k.
// The sender-side rows come from their own tables and row stride (the node
// tables, stride HF; a ring hop's sender buffers, stride HF, whose row
// count need not be the receiver side's; or the window, stride HF for v1
// and 2HF for v2, whj in columns [0, HF) and whi in [HF, 2HF)); the
// receiver side (v1: f_dst, bound; v2: whi[r], ub) always from the node
// tables. In every order:
//   * A block owns one 128-row receiver tile's chunk range
//     [tile_ptr[t], tile_ptr[t + 1]) and one group of heads. Within it a
//     unit of P lanes owns one tile row: it walks that row's run, TF_BATCH
//     slots at a time (their index words, then their sender rows and keep
//     factors all in flight before the first FLOP), forms each (slot,
//     head) logit from the sender row it loaded (v1: the message's row
//     gives l_src too; v2: the receiver's whi[r] and ub[r] are loaded once
//     per row and kept in registers), and sums the row's message and
//     denominator in registers. The row is then stored once, with plain
//     stores, every row of the tile, zeros included. No atomic and no
//     memset: the summation order is fixed by the walk, so two calls give
//     the same bits.
//   * A run longer than TF_SPLIT slots (a hub's row) would leave its unit
//     walking while the others idle: such runs are cut into segments of
//     TF_SPLIT slots, which all the block's units walk, one segment each a
//     round, each into a partial sum in shared memory that the row's own
//     unit adds in segment order. This is a second instantiation of the
//     kernel (kSplit), launched only for a walk whose longest run (max_run,
//     its largest in-degree) exceeds TF_SPLIT: its shared memory, barriers
//     and second walk cost registers, and the 524k graph's kernels 1.2x
//     their time. The hub graph's tile pieces, one unit walking some 250 hub
//     slots each, took 3.5x the first port's time without it.
//   * Lanes: a head of F features takes Q = pow2 >= ceil(F / 8) lanes of C
//     = ceil(F / Q) <= 8 consecutive columns each (float4 loads where C and
//     F are multiples of 4 and the tables 16-byte aligned); the head's
//     lanes sum the logit's terms with xor shuffles within the unit (none
//     at F <= 8). A unit covers hb heads (hb * Q <= 32 lanes), P = pow2 >=
//     hb * Q. So Cora's and the 524k graph's layer 1 (H 8, F 8) runs 8-lane
//     units, one head a lane, and layer 2 (H 1, F 4 or 7) one-lane units:
//     32 rows a warp, not one row with 28 lanes idle. v2's F-sum over both
//     ends (no per-node part can be precomputed) is this same split, with
//     C columns a lane instead of one.
//   * A block holds 128 / B rows (at most 256 threads): B = P / 2 blocks
//     share a tile at P >= 2, and a grid of fewer than two blocks per SM
//     (Cora's band plan: 22 tiles on 132 SMs) doubles B down to one warp a
//     block.
//   * A tile that the host cuts (split_at: a hub's tile) is walked as
//     pieces, each clipping its rows' runs to its chunk range and storing
//     into part_out / part_den, then added into out and den in order
//     (tile_pieces.cuh).
// pygat_tpu_torch/tools/banded_ab.py times these kernels in every order
// against another checkout's, and their time by altered copies (--ablate).
//
// The one-limb instantiations (fused_v1_bf16.cu, fused_v2_bf16.cu,
// fused_v1_window_bf16.cu, fused_v2_window_bf16.cu,
// fused_v1_banded_bf16.cu, fused_v2_banded_bf16.cu: the TPU kernels at
// two_limb=False, precision="fastest", as their interpret mode computes)
// read the sender-side rows from a bf16 copy of the node table(s) or of
// the window that the wrapper makes once a call (the TPU kernels' bf16
// window, at half the gather bytes), and round at the reference's points:
// a enters the logit as bf16; v2's LeakyReLU'd pre-sum is rounded to bf16
// before its product with a (the receiver's whi[r] stays f32); each
// message row(s) * num * keepq is rounded to bf16 before it is added;
// exp, num, den and both accumulators stay f32 (kOne below).
//
// Bound on the H100: bytes of the function (each node table once, or over
// a window its live rows once, 2 bytes a value for a one-limb sender
// table; the per-node head terms; a live slot's keep factors; the edge
// order's index words; out and den once); about 4 HF (v1) or 6 HF (v2)
// FLOPs per live slot. The walk's words and row_ptr are
// the kernel's own layout and not counted. Sender rows that neighbouring
// tiles share (a band plan's window of w tiles, a clustered graph's
// stream) come from L2 after their first touch; a window's rows are read
// once, in position order.

#pragma once

#include <cstdint>
#include <type_traits>

#include "tile_pieces.cuh"

namespace {

constexpr int TF_THREADS = 256;  // most threads a block
constexpr int TF_BATCH = 4;      // slots a unit has in flight
constexpr int TF_MAX_C = 8;      // columns a lane covers
constexpr int TF_MAX_F = 256;    // widest head
constexpr int TF_SPLIT = 32;     // longest run a unit walks alone

// The arguments of both forwards. v1: sj = the message's rows (wh, or the
// window), si and xr unused, fd = f_dst, shift = bound; v2: sj = whj and
// si = whi at the sender (the node tables, the window's two column halves,
// or a ring hop's sender buffers), xr = whi (the receiver's rows: the same
// table as si on one device, this shard's block in a ring hop), fd unused,
// shift = ub. s_stride is read over a window only (SlotWalk). S, the
// type of the sender-side rows: float, or __nv_bfloat16 in the one-limb
// instantiations.
template <class S>
struct FusedArgsT {
  const S* sj;
  const S* si;
  int s_stride;        // row stride of sj and si
  const float* xr;     // [N, HF]
  const float* fd;
  const float* shift;
  const float* a;      // [H, F]
  const float* keepq;  // [E, H], rows named by the walk
  const int* row_ptr;  // [n_tiles * 129 + 1] first position of each key
  const int* tile_ptr;
  const int* split_at;
  int n_tiles, n_split, H, F;
  float alpha;
  float* out;       // [n_tiles * 128, HF]
  float* den;       // [n_tiles * 128, H]
  float* part_out;  // [n_split, 128, HF]
  float* part_den;  // [n_split, 128, H]
  int hpb, Q, P;    // heads a block, lanes a head, lanes a unit
};
using FusedArgs = FusedArgsT<float>;

// the one-limb instantiation: bf16 sender rows, rounded logit operands and
// messages
template <class S>
constexpr bool kOne = std::is_same<S, __nv_bfloat16>::value;

// Walk policies: by walk position k, the slot's sender-side row and its
// row of keepq; kWindow: the sender-side rows (sj, and si for v2's whi)
// are a window's, at stride s_stride, else tables' rows at stride HF.
struct BandWalk {  // a band plan's walk
  static constexpr bool kWindow = false;
  const int* rows;   // [E_b] sender row by position (-1 dead)
  const int* order;  // [E_b] banded slot by position
  __device__ int row(int k) const { return __ldg(rows + k); }
  __device__ int keep(int k) const { return __ldg(order + k); }
};

struct ListWalk {  // the receiver stream, senders listed by position
  static constexpr bool kWindow = false;
  const int* senders;  // [E_s]
  __device__ int row(int k) const { return __ldg(senders + k); }
  __device__ int keep(int k) const { return k; }
};

struct SlotWalk {  // the stream over a window holding row k for slot k
  static constexpr bool kWindow = true;
  __device__ int row(int k) const { return k; }
  __device__ int keep(int k) const { return k; }
};

// What one lane of a unit covers: head h (on: one of the block's), the C
// columns col .. col + nf - 1 of the [N, HF] tables, its head's a, and the
// lanes of its unit, which alone take part in its shuffles.
template <int C>
struct Lane {
  int h, col, nf, Q;
  bool on;
  unsigned umask;
  float a[C];
};

// Adds the slots at walk positions [lo, hi), all of receiver row r, into
// acc (the message, this lane's columns) and dsum (the denominator, the
// lane's head), in position order; the unit's lanes call it together.
template <int C, bool kVec, bool kV2, class Walk, class S>
__device__ __forceinline__ void walk_run(const FusedArgsT<S>& p, const Walk& w,
                                         const Lane<C>& ln, long long r,
                                         int lo, int hi, float (&acc)[C],
                                         float& dsum) {
  const int H = p.H, HF = p.H * p.F;
  const int stride = Walk::kWindow ? p.s_stride : HF;
  // the receiver's operands, once per run
  float rv[kV2 ? C : 1];
  float fd = 0.f;
  if constexpr (kV2)
    load_cols<C, kVec>(p.xr + r * HF + ln.col, ln.nf, rv);
  else
    fd = ln.on ? __ldg(p.fd + r * H + ln.h) : 0.f;
  const float shift = ln.on ? __ldg(p.shift + r * H + ln.h) : 0.f;

  for (int k0 = lo; k0 < hi; k0 += TF_BATCH) {
    const int n = min(TF_BATCH, hi - k0);  // the same for the unit
    int s[TF_BATCH], o[TF_BATCH];
#pragma unroll
    for (int u = 0; u < TF_BATCH; ++u) {
      s[u] = u < n ? w.row(k0 + u) : 0;
      o[u] = u < n ? w.keep(k0 + u) : 0;
    }
    float vj[TF_BATCH][C];  // v1: wh[s]; v2: whj[s]
    float vi[kV2 ? TF_BATCH : 1][C];  // v2: whi[s]
    float kq[TF_BATCH];
#pragma unroll
    for (int u = 0; u < TF_BATCH; ++u) {
      const long long at = static_cast<long long>(s[u]) * stride + ln.col;
      const int m = u < n ? ln.nf : 0;
      load_cols<C, kVec>(p.sj + at, m, vj[u]);
      if constexpr (kV2) load_cols<C, kVec>(p.si + at, m, vi[u]);
      kq[u] = u < n && ln.on
                  ? __ldg(p.keepq + static_cast<long long>(o[u]) * H + ln.h)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < TF_BATCH; ++u) {
      if (u < n) {  // uniform over the unit
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if constexpr (kV2) {
            const float x = rv[i] + vj[u][i];
            float pre = x >= 0.f ? x : p.alpha * x;
            if constexpr (kOne<S>) pre = bf16_round(pre);
            part = fmaf(pre, ln.a[i], part);
          } else {
            part = fmaf(vj[u][i], ln.a[i], part);
          }
        }
        for (int off = ln.Q >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(ln.umask, part, off);
        float num;
        if constexpr (kV2) {
          num = expf(part - shift);
        } else {
          const float raw = fd + part;
          num = expf((raw >= 0.f ? raw : p.alpha * raw) - shift);
        }
        const float q = num * kq[u];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          float v;
          if constexpr (kV2)
            v = vi[u][i];
          else
            v = vj[u][i];
          if constexpr (kOne<S>)
            acc[i] += bf16_round(v * q);  // the message, rounded, then added
          else
            acc[i] = fmaf(v, q, acc[i]);
        }
        dsum += num;
      }
    }
  }
}

// gridDim = (n_tiles + n_split, head groups, B); blockDim = 128 / B units
// of P lanes. kSplit: runs longer than TF_SPLIT slots may occur (the
// walk's max_run says so), and are cut into segments.
template <int C, bool kVec, bool kV2, bool kSplit, class Walk, class S>
__global__ void __launch_bounds__(TF_THREADS)
tile_fused_kernel(const FusedArgsT<S> p, const Walk w) {
  const int P = p.P, H = p.H, F = p.F;
  const int units = blockDim.x / P;
  const int unit = threadIdx.x / P;
  const int lu = threadIdx.x & (P - 1);
  Lane<C> ln;
  ln.Q = p.Q;
  const int h0 = blockIdx.y * p.hpb;
  const int hl = lu / ln.Q;
  ln.on = hl < min(p.hpb, H - h0);
  ln.h = ln.on ? h0 + hl : h0;
  const int f0 = (lu & (ln.Q - 1)) * C;
  ln.nf = ln.on ? max(0, min(C, F - f0)) : 0;
  ln.col = ln.h * F + f0;
  ln.umask = P == 32 ? 0xffffffffu
                     : ((1u << P) - 1) << ((threadIdx.x & 31) & ~(P - 1));
  load_cols<C, false>(p.a + ln.col, ln.nf, ln.a);
  if constexpr (kOne<S>) {  // a enters the logit as bf16
#pragma unroll
    for (int i = 0; i < C; ++i) ln.a[i] = bf16_round(ln.a[i]);
  }

  // the block's chunk range (tile_pieces.cuh) and the unit's row's run
  // within it
  const TileRange tr =
      tile_range(blockIdx.x, p.tile_ptr, p.split_at, p.n_tiles, p.n_split);
  const int l = blockIdx.z * units + unit;
  const int key = tr.tile * (TILE + 1) + l;
  const int lo = max(__ldg(p.row_ptr + key), tr.c_lo * EC);
  const int hi = min(__ldg(p.row_ptr + key + 1), tr.c_hi * EC);
  const long long r = static_cast<long long>(tr.tile) * TILE + l;

  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  float dsum = 0.f;
  const bool heavy = kSplit && hi - lo > TF_SPLIT;
  if (lo < hi && !heavy)
    walk_run<C, kVec, kV2>(p, w, ln, r, lo, hi, acc, dsum);

  if constexpr (kSplit) {
    // the long runs are cut into segments of TF_SPLIT slots, which all the
    // block's units walk, a round of one segment each at a time; the long
    // row's own unit adds their partial sums in segment order
    __shared__ int s_first[TILE + 1];  // a row's first segment
    __shared__ int s_lo[TILE], s_hi[TILE];
    __shared__ float s_part[TF_THREADS * (C + 1)];  // a round's sums
    if (__syncthreads_or(heavy)) {  // the same for the block
      if (lu == 0) {
        s_first[unit] = heavy ? (hi - lo + TF_SPLIT - 1) / TF_SPLIT : 0;
        s_lo[unit] = lo;
        s_hi[unit] = hi;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int sum = 0;
        for (int u = 0; u < units; ++u) {
          const int n = s_first[u];
          s_first[u] = sum;
          sum += n;
        }
        s_first[units] = sum;
      }
      __syncthreads();
      const int n_seg = s_first[units];
      for (int base = 0; base < n_seg; base += units) {
        const int g = base + unit;
        float pa[C];
#pragma unroll
        for (int i = 0; i < C; ++i) pa[i] = 0.f;
        float pd = 0.f;
        if (g < n_seg) {
          // the row whose segments hold g: the last one starting at or
          // before it
          const int j = lower_bound(s_first, units + 1, g + 1) - 1;
          const int seg = s_lo[j] + (g - s_first[j]) * TF_SPLIT;
          walk_run<C, kVec, kV2>(p, w, ln, r - unit + j, seg,
                                 min(seg + TF_SPLIT, s_hi[j]), pa, pd);
        }
        float* mine = s_part + threadIdx.x * (C + 1);
#pragma unroll
        for (int i = 0; i < C; ++i) mine[i] = pa[i];
        mine[C] = pd;
        __syncthreads();
        if (heavy) {
          const int e = min(base + units, s_first[unit + 1]);
          for (int g2 = max(base, s_first[unit]); g2 < e; ++g2) {
            const float* src = s_part + ((g2 - base) * P + lu) * (C + 1);
#pragma unroll
            for (int i = 0; i < C; ++i) acc[i] += src[i];
            dsum += src[C];
          }
        }
        __syncthreads();
      }
    }
  }

  // the row, once: the tile's first piece into out and den, another into
  // its part
  const long long row =
      (tr.piece < 0 ? r : static_cast<long long>(tr.piece) * TILE + l);
  float* o_out = (tr.piece < 0 ? p.out : p.part_out) + row * H * F + ln.col;
  store_cols<C, kVec>(o_out, ln.nf, acc);
  if (ln.on && f0 == 0)
    (tr.piece < 0 ? p.den : p.part_den)[row * H + ln.h] = dsum;
}

template <int C, bool kVec, bool kV2, class Walk, class S>
void launch_split(const FusedArgsT<S>& p, const Walk& w, bool split,
                  dim3 grid, int threads, cudaStream_t st) {
  if (split)
    tile_fused_kernel<C, kVec, kV2, true, Walk, S>
        <<<grid, threads, 0, st>>>(p, w);
  else
    tile_fused_kernel<C, kVec, kV2, false, Walk, S>
        <<<grid, threads, 0, st>>>(p, w);
}

template <int C, bool kV2, class Walk, class S>
int launch_c(const FusedArgsT<S>& p, const Walk& w, bool vec, bool split,
             dim3 grid, int threads, cudaStream_t st) {
  if constexpr (C % 4 == 0) {
    if (vec) {
      launch_split<C, true, kV2>(p, w, split, grid, threads, st);
      return static_cast<int>(cudaGetLastError());
    }
  }
  launch_split<C, false, kV2>(p, w, split, grid, threads, st);
  return static_cast<int>(cudaGetLastError());
}

// Launches the forward over walk `w` on `stream` (cutting runs into
// segments when the walk's longest run, max_run, exceeds TF_SPLIT), then,
// if any tile is split, adds the pieces into out and den. Returns the first
// CUDA error, or cudaGetLastError() after the launches
// (cudaErrorInvalidValue when F > 256).
template <bool kV2, class Walk, class S>
int launch_tile_fused(FusedArgsT<S> p, Walk w, int max_run, void* stream) {
  if (p.n_tiles <= 0 || p.H <= 0) return 0;
  if (p.F <= 0 || p.F > TF_MAX_F)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.Q = 1;
  while (p.Q * TF_MAX_C < p.F) p.Q <<= 1;
  const int C = (p.F + p.Q - 1) / p.Q;
  p.hpb = p.H < 32 / p.Q ? p.H : 32 / p.Q;
  p.P = 1;
  while (p.P < p.hpb * p.Q) p.P <<= 1;
  const auto aligned = [](const void* q) {
    return q == nullptr || reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  const bool vec = C % 4 == 0 && p.F % 4 == 0 && p.s_stride % 4 == 0 &&
                   aligned(p.sj) && aligned(p.si) && aligned(p.xr) &&
                   aligned(p.out) && aligned(p.part_out);

  dim3 grid(p.n_tiles + p.n_split, (p.H + p.hpb - 1) / p.hpb, 1);
  while (TILE / grid.z * p.P > TF_THREADS) grid.z *= 2;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a grid of fewer than two blocks an SM: smaller blocks, more of them
  while (2LL * sms > 1LL * grid.x * grid.y * grid.z &&
         TILE / grid.z * p.P > 32)
    grid.z *= 2;
  const int threads = TILE / grid.z * p.P;
  const bool split = max_run > TF_SPLIT;

  int rc = 0;
  switch (C) {
    case 1: rc = launch_c<1, kV2>(p, w, vec, split, grid, threads, st); break;
    case 2: rc = launch_c<2, kV2>(p, w, vec, split, grid, threads, st); break;
    case 3: rc = launch_c<3, kV2>(p, w, vec, split, grid, threads, st); break;
    case 4: rc = launch_c<4, kV2>(p, w, vec, split, grid, threads, st); break;
    case 5: rc = launch_c<5, kV2>(p, w, vec, split, grid, threads, st); break;
    case 6: rc = launch_c<6, kV2>(p, w, vec, split, grid, threads, st); break;
    case 7: rc = launch_c<7, kV2>(p, w, vec, split, grid, threads, st); break;
    default: rc = launch_c<8, kV2>(p, w, vec, split, grid, threads, st); break;
  }
  if (rc != 0) return rc;
  rc = launch_tile_combine(p.tile_ptr, p.n_tiles, p.split_at, p.n_split,
                           p.H * p.F, p.part_out, p.out, st);
  if (rc != 0) return rc;
  return launch_tile_combine(p.tile_ptr, p.n_tiles, p.split_at, p.n_split,
                             p.H, p.part_den, p.den, st);
}

}  // namespace
