// Tile-owner SpMM for Hopper (sm_90a), templated on where a slot's row
// comes from (shared by spmm_banded.cu and panel_spmm.cu).
//
// The edge order is cut into chunks of EC = 256 slots; every chunk writes
// one 128-row output tile, and the chunks of tile t are the contiguous range
// [tile_ptr[t], tile_ptr[t + 1]) (the chunk-to-tile map is non-decreasing;
// the host derives tile_ptr once per layout or plan). The slot at position
// k of chunk c adds vals[order[k]] * x[rows(k, c)] into row local[k] of its
// tile (order null: the slot is k itself); local[k] outside [0, 128), a row
// of -1 (slot_rows.cuh: ListedRows, WindowRows, PanelRows) or a false mask
// byte marks a dead slot, which adds nothing and reads nothing of x.
//
// One block owns one output tile and one slab of at most 128 columns, and
// walks the tile's chunk range:
//   * the tile's sum stays on chip: an f32 [128, cols] accumulator in shared
//     memory (64 KB at 128 columns), zeroed at the start and written once at
//     the end with coalesced plain stores, every row, zeros included. No
//     memset of the output, no global atomic;
//   * warp w of the block's 8 owns the tile rows r with r % 8 == w, and only
//     it adds into them, in the walk's order, with plain shared-memory
//     adds: the sum's order is fixed by the data, so the result is bitwise
//     the same from call to call (a shared-memory float atomic is a
//     compare-and-swap loop on sm_90, 1.24–1.29x slower here, and its order
//     would vary). Three blocks fit on an SM (80 registers a thread, 64 KB +
//     6.5 KB of shared memory a block; two are 1.18–1.22x slower). A grid of
//     less than one wave of blocks (Pubmed's 155 tiles on 132 SMs) leaves
//     SMs idle and each block's walk on the critical path: there B = 2 or 4
//     blocks share each tile, block b owning the rows r with r % 8B in
//     [8 b, 8 b + 8), each with a [128 / B, cols] accumulator;
//   * the block stages one chunk at a time in shared memory, thread t
//     resolving position t once (its local row, its row of x through the
//     row policy, -1 when dead or another block's, its weight and owning
//     warp), double-buffered with one barrier per chunk: the next chunk's
//     index words are loaded while this chunk's rows are read;
//   * a warp walks the staged chunk 64 slots at a time: two ballots list
//     the slots whose rows it owns, their positions are taken 8 at a time,
//     and their staged words and rows of x are read all at once, one slot
//     row per warp-wide load (a float4 per lane where L % 4 == 0 and the
//     pointers are 16-byte aligned, else 4 scalar loads per lane), before
//     the first add. Runs of equal local rows sum in registers and reach
//     shared memory once per run: the receiver stream is in receiver order,
//     and the banded SpMM walks each tile's slots with receivers ascending.
//     No barrier stands between loading and adding;
//   * a tile whose block would walk too much (more than HEAVY_CHUNKS
//     chunks, or more than WARP_SLOTS live slots on one warp's rows: a
//     hub's tile) is cut by the host into pieces, one block each, and a
//     second small kernel adds the pieces into the output in order
//     (tile_pieces.cuh). Only split tiles pay for it, and the sum stays
//     reproducible.
// The first design (every warp resolving every slot itself from memory,
// eight times over; one block per tile whatever the grid; the banded slots
// in the plan's sender order) took 1.20–1.69x as long.
//
// Bound on the H100: bytes (x once, out once, per slot its index and value
// words; two FLOPs per live slot and column). The rows of a tile's slots
// come from a few nearby 128-row tiles of x, so after the first touch they
// come from L2. What holds the kernel is the L2-to-SM row traffic and the
// walk's per-slot work: at 524k, L = 128 (pygat_tpu_torch/tools/spmm_ab.py
// --ablate; NVIDIA H100 80GB HBM3, 700.00 W) skipping the row loads saves
// 36–38 % of the time, L = 64 in place of 128 saves 8–12 %, and skipping
// the shared-memory adds 4–5 %.
//
// The one-limb instantiations (spmm_banded_bf16.cu, panel_spmm_bf16.cu: the
// TPU kernels at exact=False / two_limb=False, precision="fastest", as
// their interpret mode computes) read x from a bf16 copy that the wrapper
// makes once a call (T = __nv_bfloat16: 4 values, 8 bytes, a lane's load
// where L % 4 == 0 and the rows are 8-byte aligned, else scalar loads; the
// bits are widened where they are added, so the batch's loads stay in
// flight together), and form each message as the reference does
// (OneLimbMsg): the product w * v in f32 (__fmul_rn: an FMA would skip the
// rounding), rounded to bf16 (to nearest, ties to even; two messages a
// conversion), and only then added into the run's f32 sum. Row 7 folds its
// value into the bf16 select one-hot, so its value is rounded to bf16 once,
// when the slot is staged (kRoundW); row 9 scales the bf16 rows by its f32
// value. The f32 instantiations (ExactMsg) fuse w * v into the run's sum.
// The rounding costs the one-limb kernels more than the halved row bytes
// save (PERF.md §6).

#pragma once

#include <cstdint>
#include <type_traits>

#include "tile_pieces.cuh"

namespace {

constexpr int TS_WARPS = 8;      // warps of a tile-owner block
constexpr int TS_SLAB = 128;   // columns per block: 32 lanes x 4
constexpr int TS_GROUP = 64;   // slots a warp's two ballots cover
constexpr int TS_BATCH = 8;    // slot rows a warp has in flight
constexpr unsigned FULL = 0xffffffffu;

// Message policies: the staged weight of a slot's value, what a lane's four
// row values become before they are added (prepare), the first message of
// a run and a message added into it.
struct ExactMsg {  // 'high': f32 rows, w * v fused into the run's sum
  __device__ static float weight(float w) { return w; }
  __device__ static void prepare(float, float (&)[4]) {}
  __device__ static float first(float w, float v) { return w * v; }
  __device__ static float add(float w, float v, float sum) {
    return fmaf(w, v, sum);
  }
};

template <bool kRoundW>  // row 7: the value rounded to bf16 when staged
struct OneLimbMsg {  // 'fastest': bf16(f32 w * v), then added in f32
  __device__ static float weight(float w) {
    return kRoundW ? bf16_round(w) : w;
  }
  // the four messages, rounded two to a conversion
  __device__ static void prepare(float w, float (&v)[4]) {
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(__fmul_rn(w, v[h]), __fmul_rn(w, v[h + 1]));
      v[h] = __low2float(p);
      v[h + 1] = __high2float(p);
    }
  }
  __device__ static float first(float, float m) { return m; }
  __device__ static float add(float, float m, float sum) {
    return __fadd_rn(sum, m);
  }
};

// The value of the slot at position k of the walk, and whether it is kept:
// the slot is order[k] (order null: k itself), its value vals[slot], kept
// unless mask[slot] (one bool byte per slot, or null) is false.
struct SlotValues {
  const float* vals;
  const unsigned char* mask;
  const int* order;
  __device__ long long slot(long long k) const {
    return order == nullptr ? k : __ldg(order + k);
  }
  __device__ bool keep(long long k) const {
    return mask == nullptr || mask[slot(k)] != 0;
  }
  __device__ float operator()(long long k) const {
    return __ldg(vals + slot(k));
  }
};

// The four columns lane `lane` covers in a slab of `cols` columns: 4 * lane
// .. 4 * lane + 3 (kVec), or lane + 32 q (scalar); from f32 rows, or (the
// overload below) the bits of bf16 rows, which row_values widens.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int lane, int cols, float v[4]) {
  if constexpr (kVec) {
    if (4 * lane < cols) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src) + lane);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < cols) v[q] = __ldg(src + lane + 32 * q);
  }
}

// A bf16 row's bits, as loaded: kVec, the lane's four values packed in
// v[0], v[1] (8 bytes, one load); scalar, one value in the low half of
// each v[q]. They are widened where they are added (row_values), not here:
// a widening beside its load waits for the load inside the batch's
// warp-uniform branch, and the batch's row loads no longer overlap (the
// one-limb kernel then took 1.54x the f32 kernel's time at 524k, L = 128:
// chip_smoke.py phase 6).
template <bool kVec>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ src,
                                         int lane, int cols, float v[4]) {
  if constexpr (kVec) {
    if (4 * lane < cols) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src) + lane);
      v[0] = __uint_as_float(t.x);
      v[1] = __uint_as_float(t.y);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < cols)
        v[q] = __uint_as_float(static_cast<unsigned>(__ldg(u + lane + 32 * q)));
  }
}

// The four f32 values of a lane's loaded row: an f32 row's as they are; a
// bf16 row's bits widened (a bf16 value is the top half of the f32 of the
// same value, so the widening is exact).
template <bool kVec, class T>
__device__ __forceinline__ void row_values(const float (&v)[4],
                                           float (&m)[4]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = v[q];
  } else if constexpr (kVec) {
    const unsigned a = __float_as_uint(v[0]), b = __float_as_uint(v[1]);
    m[0] = __uint_as_float(a << 16);
    m[1] = __uint_as_float(a & 0xffff0000u);
    m[2] = __uint_as_float(b << 16);
    m[3] = __uint_as_float(b & 0xffff0000u);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = __uint_as_float(__float_as_uint(v[q]) << 16);
  }
}

template <bool kVec>
__device__ __forceinline__ void add_row(float* a, int lane, int cols,
                                        const float s[4]) {
  if constexpr (kVec) {
    if (4 * lane < cols) {
      float4* p = reinterpret_cast<float4*>(a) + lane;
      float4 t = *p;
      t.x += s[0];
      t.y += s[1];
      t.z += s[2];
      t.w += s[3];
      *p = t;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < cols) a[lane + 32 * q] += s[q];
  }
}

// the shared-memory staging of one chunk's slots: row of x (-1 when dead
// or another block's), accumulator row, weight, and the warp that adds the
// slot (-1 when none of the block's does)
struct Stage {
  int row[EC];
  int loc[EC];
  float w[EC];
  signed char owner[EC];
};
constexpr size_t TS_STAGE_BYTES = 2 * sizeof(Stage);

// Takes up to TS_BATCH of the warp's live slots off the masks m0, m1 (bit j:
// slot g + j, resp. g + 32 + j, of the staged chunk), in slot order, and
// issues their row loads; returns how many. The positions come first, so
// that the staged words and the rows of the batch are all read at once.
template <bool kVec, class T>
__device__ __forceinline__ int issue_batch(unsigned& m0, unsigned& m1,
                                           const Stage& st, int g,
                                           const T* __restrict__ x,
                                           int L, int c0, int lane, int cols,
                                           float (&v)[TS_BATCH][4],
                                           float (&wu)[TS_BATCH],
                                           int (&lu)[TS_BATCH]) {
  const int n = min(__popc(m0) + __popc(m1), TS_BATCH);
  int at[TS_BATCH];
#pragma unroll
  for (int u = 0; u < TS_BATCH; ++u) {
    const bool lo = m0 != 0;
    const unsigned m = lo ? m0 : m1;
    at[u] = g + (lo ? 0 : 32) + __ffs(m) - 1;
    if (lo)
      m0 &= m0 - 1;
    else
      m1 &= m1 - 1;
  }
#pragma unroll
  for (int u = 0; u < TS_BATCH; ++u) {
    if (u < n) {  // warp-uniform
      const int r = st.row[at[u]];
      wu[u] = st.w[at[u]];
      lu[u] = st.loc[at[u]];
      load_row<kVec>(x + static_cast<long long>(r) * L + c0, lane, cols,
                     v[u]);
    }
  }
  return n;
}

// Adds the n loaded rows, in slot order: a run of equal local rows sums in
// `sum`, and reaches the accumulator when the row changes; Msg forms each
// message and adds it. T: the type of the rows' values (row_values).
template <bool kVec, class Msg, class T>
__device__ __forceinline__ void add_batch(int n, const float (&v)[TS_BATCH][4],
                                          const float (&wu)[TS_BATCH],
                                          const int (&lu)[TS_BATCH], int& cur,
                                          float (&sum)[4], float* acc,
                                          int lane, int cols) {
#pragma unroll
  for (int u = 0; u < TS_BATCH; ++u) {
    if (u >= n) break;
    float m[4];
    row_values<kVec, T>(v[u], m);
    Msg::prepare(wu[u], m);
    if (lu[u] != cur) {
      if (cur >= 0) add_row<kVec>(acc + cur * cols, lane, cols, sum);
      cur = lu[u];
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[q] = Msg::first(wu[u], m[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[q] = Msg::add(wu[u], m[q], sum[q]);
    }
  }
}

// A slot's index words, loaded ahead of its chunk.
struct SlotWords {
  int loc, word;
  float val;
  bool keep;
};

template <class Rows>
__device__ __forceinline__ SlotWords load_words(Rows rows, SlotValues w,
                                                const int* __restrict__ local,
                                                long long k) {
  return SlotWords{__ldg(local + k), rows.word(k), w(k), w.keep(k)};
}

// Stages slot t of a chunk for block b of the B = 2^lb that share its
// tile: the rows r with r % (8 B) in [8 b, 8 b + 8) are the block's, warp
// r % 8 adding them into accumulator row (r / (8 B)) * 8 + r % 8. The
// staged weight is Msg's.
template <class Msg, class Rows>
__device__ __forceinline__ void stage_slot(Stage& st, Rows rows,
                                           const SlotWords& sw, int chunk,
                                           int t, int b, int lb) {
  int row = -1, q = TILE, owner = -1;
  if (static_cast<unsigned>(sw.loc) < TILE &&
      ((sw.loc >> 3) & ((1 << lb) - 1)) == b) {
    const int r = rows.row(sw.word, chunk);
    if (r >= 0 && sw.keep) {
      row = r;
      owner = sw.loc & (TS_WARPS - 1);
      q = ((sw.loc >> (3 + lb)) << 3) + owner;
    }
  }
  st.row[t] = row;
  st.loc[t] = q;
  st.w[t] = Msg::weight(sw.val);
  st.owner[t] = static_cast<signed char>(owner);
}

// 8 warps a block, three blocks per SM; gridDim.z = B blocks share a
// tile's rows; T, the type of x's rows (float, or __nv_bfloat16 in the
// one-limb instantiations); Msg, how a message is formed and added
template <bool kVec, class Rows, class T, class Msg>
__global__ void __launch_bounds__(TS_WARPS * 32, 3)
tile_spmm_kernel(const T* __restrict__ x, Rows rows, SlotValues w,
                 const int* __restrict__ local,
                 const int* __restrict__ tile_ptr,
                 const int* __restrict__ split_at, int n_tiles, int n_split,
                 int L, float* __restrict__ out, float* __restrict__ part) {
  constexpr int THREADS = TS_WARPS * 32;
  static_assert(THREADS == EC, "thread t stages slot t of a chunk");
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // [TILE / B, cols]
  __shared__ Stage stage[2];
  const int c0 = blockIdx.y * TS_SLAB;
  const int cols = min(TS_SLAB, L - c0);
  static_assert(TS_WARPS == 8, "a block's rows are r % 8 per warp");
  const int b = blockIdx.z, lb = __ffs(gridDim.z) - 1;  // B = 2^lb
  const int n_rows = TILE >> lb;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  // the block's tile and chunk range [c_lo, c_hi) (tile_pieces.cuh)
  const TileRange tr = tile_range(blockIdx.x, tile_ptr, split_at, n_tiles,
                                  n_split);
  const int c_lo = tr.c_lo, c_hi = tr.c_hi;
  float* o = (tr.piece < 0 ? out + static_cast<long long>(tr.tile) * TILE * L
                           : part + static_cast<long long>(tr.piece) * TILE * L)
             + c0;

  for (int i = t; i < n_rows * cols; i += THREADS) acc[i] = 0.f;
  if (c_lo < c_hi)
    stage_slot<Msg>(stage[0], rows,
               load_words(rows, w, local, static_cast<long long>(c_lo) * EC + t),
               c_lo, t, b, lb);
  __syncthreads();

  int cur = -1;  // the accumulator row whose run `sum` holds
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = c_lo; c < c_hi; ++c) {
    const Stage& st = stage[(c - c_lo) & 1];
    const bool more = c + 1 < c_hi;
    // the next chunk's index words, in flight while this chunk's rows are
    // read
    SlotWords next{};
    if (more)
      next = load_words(rows, w, local, static_cast<long long>(c + 1) * EC + t);
    for (int g = 0; g < EC; g += TS_GROUP) {
      // the warp's live slots of the group: ballots of the staged rows
      unsigned m0 = __ballot_sync(FULL, st.owner[g + lane] == warp);
      unsigned m1 = __ballot_sync(FULL, st.owner[g + 32 + lane] == warp);
      while (m0 | m1) {  // warp-uniform
        float v[TS_BATCH][4];
        float wu[TS_BATCH];
        int lu[TS_BATCH];
        const int n = issue_batch<kVec>(m0, m1, st, g, x, L, c0, lane, cols,
                                        v, wu, lu);
        add_batch<kVec, Msg, T>(n, v, wu, lu, cur, sum, acc, lane, cols);
      }
    }
    // the other buffer was last read before the previous barrier
    if (more)
      stage_slot<Msg>(stage[(c + 1 - c_lo) & 1], rows, next, c + 1, t, b, lb);
    __syncthreads();
  }
  if (cur >= 0) add_row<kVec>(acc + cur * cols, lane, cols, sum);
  __syncthreads();

  // accumulator row q is tile row (q / 8) * 8 B + 8 b + q % 8
  if constexpr (kVec) {
    const int c4 = cols / 4;
    for (int i = t; i < n_rows * c4; i += THREADS) {
      const int q = i / c4;
      const int r = ((q >> 3) << (3 + lb)) + (b << 3) + (q & 7);
      reinterpret_cast<float4*>(o + static_cast<long long>(r) * L)[i - q * c4] =
          smem4[i];
    }
  } else {
    for (int i = t; i < n_rows * cols; i += THREADS) {
      const int q = i / cols;
      const int r = ((q >> 3) << (3 + lb)) + (b << 3) + (q & 7);
      o[static_cast<long long>(r) * L + (i - q * cols)] = acc[i];
    }
  }
}

// One block per tile (and per 128 columns), plus one per extra piece of a
// split tile, on `stream`; then, if any tile is split, the combine. part is
// [n_split, 128, L] f32 scratch (unused when n_split is 0). Returns the
// first CUDA error, or cudaGetLastError() after the launches. x's rows are
// f32 or bf16 (T); Msg as tile_spmm_kernel's (ExactMsg for f32 rows).
template <class Msg = ExactMsg, class T, class Rows>
int launch_tile_spmm(const T* x, Rows rows, SlotValues w, const int* local,
                     const int* tile_ptr, const int* split_at, int n_tiles,
                     int n_split, int L, float* out, float* part,
                     void* stream) {
  if (n_tiles <= 0 || L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p, std::uintptr_t to) {
    return reinterpret_cast<std::uintptr_t>(p) % to == 0;
  };
  // a lane's four values of x in one load (16 bytes of f32, 8 of bf16),
  // and float4 stores of the output
  const bool vec = L % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                   aligned(out, 16) && (n_split == 0 || aligned(part, 16));
  const int slab = L < TS_SLAB ? L : TS_SLAB;
  const size_t smem = sizeof(float) * TILE * slab;
  auto kernel = vec ? tile_spmm_kernel<true, Rows, T, Msg>
                    : tile_spmm_kernel<false, Rows, T, Msg>;
  cudaError_t e = cudaSuccess;
  // above 48 KB of shared memory, the static staging's included, a kernel
  // must opt in. The attribute is set on the current device only, so it is
  // set at every such launch (a host-side call of about a microsecond).
  if (smem + TS_STAGE_BYTES > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a grid of less than one wave of blocks (Pubmed's 155 tiles on the
  // H100's 132 SMs, three blocks each) leaves SMs idle and each block's
  // walk on the critical path: there B = 2 or 4 blocks share each tile's
  // rows, the largest B whose grid still fits in one wave
  dim3 grid(n_tiles + n_split, (L + TS_SLAB - 1) / TS_SLAB, 1);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      TS_WARPS * 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long wave = static_cast<long long>(sms) * per_sm;
  while (grid.z < 4 &&
         2LL * grid.z * grid.x * grid.y <= wave)
    grid.z *= 2;
  kernel<<<grid, TS_WARPS * 32, smem / grid.z, st>>>(
      x, rows, w, local, tile_ptr, split_at, n_tiles, n_split, L, out, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_tile_combine(tile_ptr, n_tiles, split_at, n_split, L, part,
                             out, st);
}

}  // namespace

// TS_WARPS, which the host's tile_ranges assumes when it cuts a hub's tile
// by its busiest warp (SPMM_WARPS in ops/stream.py); checked when the
// library loads.
extern "C" int pygat_tile_spmm_warps() { return TS_WARPS; }
