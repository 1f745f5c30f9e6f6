// Fused GATv1 attention forward over the BCSR tiling, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tests/legacy_bcsr/fused_attention.py::
// _make_kernel (launched by fused_gat_attention_fwd). Same function, on the
// same TiledGraph (legacy_bcsr/tiles.py): chunk c of 128 slots belongs to
// receiver tile I = chunk_row[c] and sender tile J = chunk_col[c]; its slot
// holds the receiver I*128 + recv_local, the sender J*128 + send_local and
// valid. For each head h and receiver i, over the valid slots of i:
//   logit = leaky_relu(f_dst[h, i] + f_src[h, s], alpha)
//   m     = max of logit                   den = sum of exp(logit - m)
//   out[h, i, :] = sum of exp(logit - m) * drop[k] * wh[h, s, :] / den
// and 0 where i has no valid slot (den = 0). drop is the dropout keep
// factor per slot (null: 1), which scales the aggregated numerators but
// not the denominator. The kernel also writes m (the true max; 0 where den
// = 0) and den [H, N_pad] for the backward.
//
// The TPU kernel walks the chunks in order on one core, carrying online
// (max, denominator, sum) accumulators of the current row tile from one
// grid step to the next, and builds every gather and scatter from one-hot
// MXU matmuls (heads folded into the lane axis, F padded), because Mosaic
// cannot gather rows. Here the kernel walks the tiling's walk
// (legacy_bcsr/tiles.py BcsrWalk, built on the host with the tiling): the
// valid slots only, re-sorted by receiver within each row tile and laid
// out as a stream of 256-position chunks per tile (ops/stream.py
// StreamWalk), so that row l of tile t is the run of positions row_ptr[key]
// .. row_ptr[key + 1] - 1, key = t * 129 + l. Position k names its
// sender's row rows[k] and its BCSR slot order[k], through which drop is
// read. Dead slots are in no run and read nothing; a row tile without a
// valid slot owns no chunk.
//   * A block owns one row tile's chunk range [tile_ptr[t], tile_ptr[t + 1])
//     and one group of heads (and, past 256 features, one group of
//     columns). A unit of P lanes owns one tile row and walks its run,
//     BA_BATCH positions at a time (their index words, then f_src[h, s], the
//     wh[h, s, :] rows and the keep factors, all in flight before the first
//     FLOP), keeping an online softmax in registers: the running max,
//     the denominator and the row's sum, both rescaled when a batch raises
//     the max. f_dst[h, r] is loaded once per row. The row, m and den are
//     then stored once with plain stores, every row of the tile: no memset,
//     no atomic, and a summation order fixed by the walk, so two calls give
//     the same bits.
//   * The tables are head-major, as the function takes them: a position's H
//     f_src terms lie in H sectors of H lines, and its H rows of wh N_pad *
//     F floats apart. f_src is read node-major, from f_src_t [N_pad, H],
//     which a first small kernel (transpose_kernel) writes: a position's H
//     terms are then one sector. That pass moves f_src twice more than the
//     function must (8 * H * N_pad bytes, not in the bound). wh is read in
//     place, H rows of F floats a position in H lines, where row 2
//     (fused_v1.cu) reads one run of H * F floats: these gathers are some
//     60 % of a 524k H 8 F 8 launch. A node-major copy of wh made them 0.1
//     ms faster there and cost as much to make, so none is made.
//   * Lanes: a head of F features takes Q = pow2 >= ceil(F / 8) lanes of C
//     = ceil(F / Q) <= 8 consecutive columns (float4 loads where C and F
//     are multiples of 4 and the tables 16-byte aligned); a unit covers hb
//     heads (hb * Q <= 32 lanes), P = pow2 >= hb * Q. So H 8 F 8 runs
//     8-lane units, one head a lane, and H 1 F 7 one-lane units. A wider
//     head goes through column groups of 256 (grid.y), each redoing the
//     softmax. A logit is one head's f_dst + f_src, so there are no lane
//     shuffles: each lane forms its head's logits from the same two loads.
//   * A run longer than BA_SPLIT positions (a hub's row) is cut into
//     segments of BA_SEG positions or more, which all the block's units
//     walk, a round of one segment each, into partial (max, den, sum)
//     states in shared memory; the row's own unit merges them in segment
//     order, rescaling to the larger max. This is a second instantiation
//     (kSplit), launched only for a walk whose longest run (max_run)
//     exceeds BA_SPLIT, with blocks of at most 128 threads.
//   * A tile that the host cuts (split_at: a hub's tile) is walked as
//     pieces, each clipping its rows' runs to its chunk range (tile_pieces.
//     cuh). Every piece of a cut tile stores its raw state, the first into
//     out, m and den, the others into part_out, part_m and part_den; then
//     bcsr_combine_kernel merges them per row into the larger max, in piece
//     order, and normalises, a block for each head and 8 rows (one block
//     a head took 65 % of the hub graph's launch).
//   * A block holds 128 / B rows (at most 256 threads, 128 in kSplit), and
//     a grid of fewer than two blocks per SM doubles B down to one warp a
//     block.
// pygat_tpu_torch/tools/banded_ab.py --bcsr times this kernel against
// another checkout's, and its time by altered copies of this file
// (--ablate).
//
// Bound on the H100: bytes. It must read f_dst, f_src and wh once, the slot
// data (recv_local, send_local, valid, drop) of the valid slots, and write
// out, m and den; the FLOPs are about 2 F + 10 per valid slot and head. The
// walk (rows, order, row_ptr, tile ranges) and f_src_t are the kernel's own
// layout and not counted.

#include <cstdint>

#include "tile_pieces.cuh"

namespace {

constexpr int BA_THREADS = 256;        // most threads a block
constexpr int BA_SPLIT_THREADS = 128;  // most threads a block of kSplit
constexpr int BA_BATCH = 4;            // positions a unit has in flight
constexpr int BA_MAX_C = 8;            // columns a lane covers
constexpr int BA_MAX_P = 32;           // lanes a unit
constexpr int BA_SPLIT = 32;           // longest run a unit walks alone
constexpr int BA_SEG = 8;              // positions of a long run's segment
constexpr int BA_COMBINE_ROWS = 8;     // rows of a cut tile a combine block
constexpr int BA_COMBINE_THREADS = 128;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

struct AttnArgs {
  const float* f_dst;  // [H, n_pad]
  const float* f_src;  // [H, n_pad]
  float* f_src_t;      // [n_pad, H] scratch: f_src node-major
  const float* wh;     // [H, n_pad, F]
  const float* drop;   // [C * 128] keep factors by BCSR slot, or null
  const int* rows;     // sender row by walk position
  const int* order;    // BCSR slot by walk position
  const int* row_ptr;  // [n_tiles * 129 + 1] first position of each key
  const int* tile_ptr;
  const int* split_at;
  int n_tiles, n_split, H, F;
  float alpha;
  float* out;       // [H, n_pad, F]
  float* m;         // [H, n_pad]
  float* den;       // [H, n_pad]
  float* part_out;  // [n_split, H, 128, F]
  float* part_m;    // [n_split, H, 128]
  float* part_den;  // [n_split, H, 128]
  int hpb, Q, P, width, n_groups;  // heads a block, lanes a head, lanes a
                                   // unit, columns a column group, head
                                   // groups
};

// What one lane covers: head h (on: one of the block's), the columns col ..
// col + nf - 1 of its head's F.
struct Lane {
  int h, col, nf;
  bool on;
};

// An online softmax of one lane: the running max mx, the denominator d =
// sum of exp(logit - mx), and the lane's columns of sum of exp(logit - mx)
// * drop * wh. Empty: mx = -inf, d = 0, acc = 0.
template <int C>
struct State {
  float mx, d;
  float acc[C];
};

template <int C>
__device__ __forceinline__ void init(State<C>& st) {
  st.mx = neg_inf();
  st.d = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) st.acc[i] = 0.f;
}

// Merges the state (pm, pd, pa) into st, both rescaled to the larger max.
template <int C>
__device__ __forceinline__ void merge(State<C>& st, float pm, float pd,
                                      const float* pa) {
  const float nm = fmaxf(st.mx, pm);
  if (nm == neg_inf()) return;  // both empty
  const float sa = expf(st.mx - nm), sb = expf(pm - nm);
  st.d = st.d * sa + pd * sb;
#pragma unroll
  for (int i = 0; i < C; ++i) st.acc[i] = st.acc[i] * sa + pa[i] * sb;
  st.mx = nm;
}

// The index words of walk positions k .. k + BA_BATCH - 1 below hi: the
// sender's row, and the BCSR slot where a keep factor is read.
__device__ __forceinline__ void load_words(const AttnArgs& p, int k, int hi,
                                           bool dropped, int (&s)[BA_BATCH],
                                           int (&o)[BA_BATCH]) {
#pragma unroll
  for (int u = 0; u < BA_BATCH; ++u) {
    s[u] = k + u < hi ? __ldg(p.rows + k + u) : 0;
    o[u] = k + u < hi && dropped ? __ldg(p.order + k + u) : 0;
  }
}

// Adds the walk positions [lo, hi), all of receiver row r, into st, in
// position order; the unit's lanes call it together.
template <int C, bool kVec>
__device__ __forceinline__ void walk_run(const AttnArgs& p, const Lane& ln,
                                         long long r, int lo, int hi,
                                         State<C>& st) {
  const long long hrow = static_cast<long long>(ln.h) * p.n_tiles * TILE;
  const float* fs = p.f_src_t + ln.h;
  const float* wh = p.wh + hrow * p.F + ln.col;
  const float fd = ln.on ? __ldg(p.f_dst + hrow + r) : 0.f;
  const bool dropped = p.drop != nullptr;
  for (int k0 = lo; k0 < hi; k0 += BA_BATCH) {
    const int n = min(BA_BATCH, hi - k0);  // the same for the unit
    int s[BA_BATCH], o[BA_BATCH];
    load_words(p, k0, hi, dropped, s, o);
    float lg[BA_BATCH], kq[BA_BATCH], v[BA_BATCH][C];
#pragma unroll
    for (int u = 0; u < BA_BATCH; ++u) {
      lg[u] = u < n && ln.on ? __ldg(fs + static_cast<long long>(s[u]) * p.H)
                             : 0.f;
      load_cols<C, kVec>(wh + static_cast<long long>(s[u]) * p.F,
                         u < n ? ln.nf : 0, v[u]);
      kq[u] = !dropped ? 1.f : u < n && ln.on ? __ldg(p.drop + o[u]) : 0.f;
    }
    float bm = neg_inf();
#pragma unroll
    for (int u = 0; u < BA_BATCH; ++u) {
      if (u < n) {
        const float x = fd + lg[u];
        lg[u] = x >= 0.f ? x : p.alpha * x;
        bm = fmaxf(bm, lg[u]);
      }
    }
    if (bm > st.mx) {  // the batch raises the max: rescale what is summed
      const float sc = expf(st.mx - bm);
      st.d *= sc;
#pragma unroll
      for (int i = 0; i < C; ++i) st.acc[i] *= sc;
      st.mx = bm;
    }
#pragma unroll
    for (int u = 0; u < BA_BATCH; ++u) {
      if (u < n) {
        const float e = expf(lg[u] - st.mx);
        st.d += e;
        const float q = e * kq[u];
#pragma unroll
        for (int i = 0; i < C; ++i) st.acc[i] = fmaf(v[u][i], q, st.acc[i]);
      }
    }
  }
}

// gridDim = (n_tiles + n_split, head groups x column groups, B); blockDim
// = 128 / B units of P lanes. kSplit: runs longer than BA_SPLIT positions
// may occur (the walk's max_run says so), and are cut into segments.
template <int C, bool kVec, bool kSplit>
__global__ void __launch_bounds__(kSplit ? BA_SPLIT_THREADS : BA_THREADS)
    bcsr_attention_kernel(const AttnArgs p) {
  const int P = p.P, H = p.H, F = p.F;
  const int units = blockDim.x / P;
  const int unit = threadIdx.x / P;
  const int lu = threadIdx.x & (P - 1);
  const int h0 = (blockIdx.y % p.n_groups) * p.hpb;
  const int cg = blockIdx.y / p.n_groups;
  const int hl = lu / p.Q;
  Lane ln;
  ln.on = hl < min(p.hpb, H - h0);
  ln.h = ln.on ? h0 + hl : h0;
  ln.col = cg * p.width + (lu & (p.Q - 1)) * C;
  ln.nf = ln.on ? max(0, min(C, F - ln.col)) : 0;
  // one lane of each head, in the first column group, stores m and den
  const bool stats = ln.on && cg == 0 && (lu & (p.Q - 1)) == 0;

  // the block's chunk range (tile_pieces.cuh) and the unit's row's run
  // within it
  const TileRange tr =
      tile_range(blockIdx.x, p.tile_ptr, p.split_at, p.n_tiles, p.n_split);
  const int l = blockIdx.z * units + unit;
  const int key = tr.tile * (TILE + 1) + l;
  const int lo = max(__ldg(p.row_ptr + key), tr.c_lo * EC);
  const int hi = min(__ldg(p.row_ptr + key + 1), tr.c_hi * EC);
  const long long r = static_cast<long long>(tr.tile) * TILE + l;

  State<C> st;
  init(st);
  const bool heavy = kSplit && hi - lo > BA_SPLIT;
  if (lo < hi && !heavy) walk_run<C, kVec>(p, ln, r, lo, hi, st);

  if constexpr (kSplit) {
    // the long runs are cut into segments, which all the block's units
    // walk, a round of one segment each at a time; the long row's own unit
    // merges their states in segment order. A run's segments are of BA_SEG
    // positions, or longer where the run has more than the block's units
    // have segments
    __shared__ int s_first[TILE + 1];  // a row's first segment
    __shared__ int s_lo[TILE], s_hi[TILE], s_len[TILE];
    __shared__ float s_part[BA_SPLIT_THREADS * (C + 2)];  // a round's states
    if (__syncthreads_or(heavy)) {  // the same for the block
      if (lu == 0) {
        const int len = max(BA_SEG, (hi - lo + units - 1) / units);
        s_first[unit] = heavy ? (hi - lo + len - 1) / len : 0;
        s_lo[unit] = lo;
        s_hi[unit] = hi;
        s_len[unit] = len;
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
        State<C> ps;
        init(ps);
        if (g < n_seg) {
          // the row whose segments hold g: the last one starting at or
          // before it
          const int j = lower_bound(s_first, units + 1, g + 1) - 1;
          const int seg = s_lo[j] + (g - s_first[j]) * s_len[j];
          walk_run<C, kVec>(p, ln, r - unit + j, seg,
                            min(seg + s_len[j], s_hi[j]), ps);
        }
        float* mine = s_part + threadIdx.x * (C + 2);
        mine[0] = ps.mx;
        mine[1] = ps.d;
#pragma unroll
        for (int i = 0; i < C; ++i) mine[2 + i] = ps.acc[i];
        __syncthreads();
        if (heavy) {
          const int e = min(base + units, s_first[unit + 1]);
          for (int g2 = max(base, s_first[unit]); g2 < e; ++g2) {
            const float* src = s_part + ((g2 - base) * P + lu) * (C + 2);
            merge(st, src[0], src[1], src + 2);
          }
        }
        __syncthreads();
      }
    }
  }

  // the row, once. An uncut tile: normalised into out, m and den. A cut
  // tile's pieces: the raw state, the first piece into out, m and den, the
  // others into their part, for bcsr_combine_kernel
  const bool cut = tr.piece >= 0 || tr.c_hi < __ldg(p.tile_ptr + tr.tile + 1);
  const long long n_pad = static_cast<long long>(p.n_tiles) * TILE;
  const long long srow =
      tr.piece < 0 ? ln.h * n_pad + r
                   : (static_cast<long long>(tr.piece) * H + ln.h) * TILE + l;
  float* o_out = (tr.piece < 0 ? p.out : p.part_out) + srow * F + ln.col;
  float* o_m = tr.piece < 0 ? p.m : p.part_m;
  float* o_den = tr.piece < 0 ? p.den : p.part_den;
  if (!cut) {
    const bool has = st.d > 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) st.acc[i] = has ? st.acc[i] / st.d : 0.f;
    if (stats) {
      o_m[srow] = has ? st.mx : 0.f;
      o_den[srow] = st.d;
    }
  } else if (stats) {
    o_m[srow] = st.mx;
    o_den[srow] = st.d;
  }
  store_cols<C, kVec>(o_out, ln.nf, st.acc);
}

// The rows of each cut tile: its pieces' raw states (the first in out, m
// and den, the others in part_*) merged per row into the largest max, in
// piece order, then normalised. The blocks of a tile's first extra piece
// do the tile, one head (grid.y) and BA_COMBINE_ROWS rows (grid.z) a
// block; the others return.
__global__ void __launch_bounds__(BA_COMBINE_THREADS)
    bcsr_combine_kernel(const AttnArgs p) {
  const int e = blockIdx.x, h = blockIdx.y, H = p.H, F = p.F;
  const int tile =
      lower_bound(p.tile_ptr, p.n_tiles + 1, p.split_at[e] + 1) - 1;
  if (e > 0 && p.split_at[e - 1] > p.tile_ptr[tile]) return;
  const int f_end = lower_bound(p.split_at, p.n_split, p.tile_ptr[tile + 1]);
  const int l0 = blockIdx.z * BA_COMBINE_ROWS;
  const long long row0 = static_cast<long long>(h) * p.n_tiles * TILE +
                         static_cast<long long>(tile) * TILE + l0;
  float* m0 = p.m + row0;
  float* d0 = p.den + row0;
  float* out = p.out + row0 * F;
  // piece f's row l of head h: part_*[(f * H + h) * TILE + l0 + l]
  const long long at0 = static_cast<long long>(h) * TILE + l0;
  const long long stride = static_cast<long long>(H) * TILE;
  __shared__ float s_m[BA_COMBINE_ROWS], s_d[BA_COMBINE_ROWS];
  for (int l = threadIdx.x; l < BA_COMBINE_ROWS; l += blockDim.x) {
    float mx = m0[l];
    for (int f = e; f < f_end; ++f)
      mx = fmaxf(mx, p.part_m[f * stride + at0 + l]);
    float d = 0.f;
    if (mx != neg_inf()) {
      d = d0[l] * expf(m0[l] - mx);
#pragma unroll 4
      for (int f = e; f < f_end; ++f) {
        const long long at = f * stride + at0 + l;
        d += p.part_den[at] * expf(p.part_m[at] - mx);
      }
    }
    s_m[l] = mx;
    s_d[l] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BA_COMBINE_ROWS * F; i += blockDim.x) {
    const int l = i / F;
    const float mx = s_m[l], d = s_d[l];
    float a = 0.f;
    if (d > 0.f) {
      a = out[i] * expf(m0[l] - mx);
#pragma unroll 4
      for (int f = e; f < f_end; ++f) {
        const long long at = f * stride + at0;
        a += p.part_out[at * F + i] * expf(p.part_m[at + l] - mx);
      }
      a /= d;
    }
    out[i] = a;
  }
  __syncthreads();  // every read of m0 and d0 is done
  for (int l = threadIdx.x; l < BA_COMBINE_ROWS; l += blockDim.x) {
    m0[l] = s_d[l] > 0.f ? s_m[l] : 0.f;
    d0[l] = s_d[l];
  }
}

// out[i, h] = in[h, i]: f_src [H, n] node-major, so that a position's H
// logit terms are one sector (one thread an element of out: the writes
// take whole lines, the reads H lines a node, which the next nodes' reads
// share)
__global__ void __launch_bounds__(256)
    transpose_kernel(const float* __restrict__ in, int H, long long n,
                     float* __restrict__ out) {
  const long long total = n * H;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < total; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = j / H;
    out[j] = __ldg(in + (j - i * H) * n + i);
  }
}

template <int C, bool kVec>
void launch_attn_split(const AttnArgs& p, bool split, dim3 grid, int threads,
                       cudaStream_t st) {
  if (split)
    bcsr_attention_kernel<C, kVec, true><<<grid, threads, 0, st>>>(p);
  else
    bcsr_attention_kernel<C, kVec, false><<<grid, threads, 0, st>>>(p);
}

template <int C>
void launch_attn_c(const AttnArgs& p, bool vec, bool split, dim3 grid,
                   int threads, cudaStream_t st) {
  if constexpr (C % 4 == 0) {
    if (vec) {
      launch_attn_split<C, true>(p, split, grid, threads, st);
      return;
    }
  }
  launch_attn_split<C, false>(p, split, grid, threads, st);
}

}  // namespace

// f_dst / f_src [H, n_tiles * 128], wh [H, n_tiles * 128, F] f32; drop [C
// * 128] f32 the keep factor by BCSR slot, or null (no dropout); the walk
// (legacy_bcsr/tiles.py BcsrWalk): rows and order [positions] int32, the
// sender's row and the BCSR slot at each position, row_ptr [n_tiles * 129
// + 1] int32, the first position of each (tile, local row) key t * 129 +
// l, tile_ptr [n_tiles + 1] and split_at [n_split] int32 (ops/stream.py
// tile_ranges), max_run the most valid slots of one receiver; out [H,
// n_tiles * 128, F], m and den [H, n_tiles * 128] f32, every element
// written; part_out [n_split, H, 128, F], part_m and part_den [n_split, H,
// 128] f32 scratch (unused when n_split is 0); f_src_t [n_tiles * 128, H]
// f32 scratch. Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches (cudaErrorInvalidValue for F < 1).
extern "C" int pygat_bcsr_attention(
    const float* f_dst, const float* f_src, const float* wh,
    const float* drop, const int* rows, const int* order, const int* row_ptr,
    const int* tile_ptr, const int* split_at, int n_tiles, int n_split,
    int max_run, int H, int F, float alpha, float* out, float* m, float* den,
    float* part_out, float* part_m, float* part_den, float* f_src_t,
    void* stream) {
  if (n_tiles <= 0 || H <= 0) return 0;
  if (F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  AttnArgs p{f_dst,    f_src,    f_src_t, wh,       drop,     rows,
             order,    row_ptr,  tile_ptr, split_at, n_tiles, n_split,
             H,        F,        alpha,   out,      m,        den,
             part_out, part_m,   part_den, 0,       0,        0,
             0,        0};
  const int fg = F < BA_MAX_P * BA_MAX_C ? F : BA_MAX_P * BA_MAX_C;
  p.Q = 1;
  while (p.Q * BA_MAX_C < fg) p.Q <<= 1;
  const int C = (fg + p.Q - 1) / p.Q;
  p.width = p.Q * C;
  p.hpb = H < BA_MAX_P / p.Q ? H : BA_MAX_P / p.Q;
  p.P = 1;
  while (p.P < p.hpb * p.Q) p.P <<= 1;
  p.n_groups = (H + p.hpb - 1) / p.hpb;
  const long long gy =
      static_cast<long long>(p.n_groups) * ((F + p.width - 1) / p.width);
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* q) {
    return q == nullptr || reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  const bool vec = C % 4 == 0 && F % 4 == 0 && aligned(wh) && aligned(out) &&
                   aligned(part_out);

  const long long n_pad = static_cast<long long>(n_tiles) * TILE;
  const long long t_blocks = (n_pad * H + 255) / 256;
  transpose_kernel<<<static_cast<unsigned>(t_blocks < 8192 ? t_blocks : 8192),
                     256, 0, st>>>(f_src, H, n_pad, f_src_t);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  const bool split = max_run > BA_SPLIT;
  dim3 grid(n_tiles + n_split, static_cast<unsigned>(gy), 1);
  while (TILE / grid.z * p.P > (split ? BA_SPLIT_THREADS : BA_THREADS))
    grid.z *= 2;
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

  switch (C) {
    case 1: launch_attn_c<1>(p, vec, split, grid, threads, st); break;
    case 2: launch_attn_c<2>(p, vec, split, grid, threads, st); break;
    case 3: launch_attn_c<3>(p, vec, split, grid, threads, st); break;
    case 4: launch_attn_c<4>(p, vec, split, grid, threads, st); break;
    case 5: launch_attn_c<5>(p, vec, split, grid, threads, st); break;
    case 6: launch_attn_c<6>(p, vec, split, grid, threads, st); break;
    case 7: launch_attn_c<7>(p, vec, split, grid, threads, st); break;
    default: launch_attn_c<8>(p, vec, split, grid, threads, st); break;
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_split <= 0) return rc;
  bcsr_combine_kernel<<<dim3(n_split, H, TILE / BA_COMBINE_ROWS),
                        BA_COMBINE_THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
