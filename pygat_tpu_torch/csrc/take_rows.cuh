// The banded take's row gather for Hopper (sm_90a): kernel row 5 in both
// precisions, banded_take.cu (f32 rows copied) and banded_take_bf16.cu (f32
// rows rounded to bf16 in registers, to nearest, ties to even, as
// Tensor.to(torch.bfloat16)).
//
// out[k, :] = table[rows(k), :] for the 256 slots of every chunk, zeros at
// a dead slot (WindowRows returns -1 there; its dead test comes before the
// row is formed). One block of 256 threads per chunk loads the chunk's row
// words once, one per thread (s_row), and then moves rows, not elements: a
// group of G lanes (a power of two, at most 32) owns one slot row at a
// time, each lane moving N values of it per step as one vector of up to 16
// bytes of output (__ldg of the table). A lane issues the loads of B rows
// before it stores any of them, so that a block of wide rows keeps 64 KB
// of reads in flight. The output is written once and read by a later
// pass: wide rows store it with streaming stores (st.global.cs), so that
// L2 keeps the table, whose rows the neighbouring chunks of a band read
// again (0.5-0.9 % faster at L = 64, 128); narrow rows with plain stores,
// which measured faster there (15 % at f32 L = 4).
//
// The launcher picks N from the alignment of L and of the two pointers
// (the widest of 16, 8, 4 or 2 bytes of output a step, each a template
// instantiation). Narrow rows, of vectors under 16 bytes or of at most 4
// vectors (layer 2's L = 4, 7, 8, 14; an unaligned table), take few rows
// in flight a lane (B <= 4, a template instantiation): a narrow row's
// block is short, its time the latency of its row words, loads and stores,
// so it gains more from occupancy than from loads in flight. Their stores
// go straight from registers: staging the chunk's [256, L] block in shared
// memory to write it with 16-byte stores measured 0-7 % slower.
//
// Bound on the H100: bytes: the table once (f32 in both precisions),
// [E_b, L] values written, the index words; no arithmetic beyond the
// rounding. expand.cu and corner_permute.cu keep slot_rows.cuh's element
// copy, gather_rows_kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "slot_rows.cuh"

namespace {

constexpr int TK_THREADS = EC;  // one thread per slot for the row words
// Rows a lane loads before it stores (B): a lane walks its column of the
// chunk in G steps (G lanes a row), so B is at most G; at most
// TK_BATCH_NARROW where rows are narrow, else about TK_RAW_REGS registers
// of rows (16 f32 vectors, or 8 of 8 f32 values to round), at most
// TK_BATCH_MAX.
constexpr int TK_RAW_REGS = 64;
constexpr int TK_BATCH_MAX = 16;
constexpr int TK_BATCH_NARROW = 4;

template <int NB>
struct Vec;  // an aligned vector of NB bytes
template <>
struct Vec<16> { using T = uint4; };
template <>
struct Vec<8> { using T = uint2; };
template <>
struct Vec<4> { using T = unsigned; };
template <>
struct Vec<2> { using T = unsigned short; };

// N values of a row: loaded from the table as Raw, stored as one Out.
template <class Tin, class Tout, int N>
struct Move {  // a copy
  static_assert(sizeof(Tin) == sizeof(Tout), "a copy keeps the type");
  using Out = typename Vec<N * sizeof(Tout)>::T;
  using Raw = Out;
  __device__ static Raw load(const Tin* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ static Out put(const Raw& r) { return r; }
};

// f32 values rounded to bf16 in registers, two at a time by
// __floats2bfloat162_rn (cvt.rn.bf16x2.f32); the loads and the roundings
// are apart, so a batch's loads are all in flight before the first wait
template <int N>
struct Move<float, __nv_bfloat16, N> {
  using Out = typename Vec<2 * N>::T;
  struct Raw {
    float v[N];
  };
  __device__ static Raw load(const float* p) {
    Raw r;
    if constexpr (N >= 4) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
        r.v[4 * q] = a.x;
        r.v[4 * q + 1] = a.y;
        r.v[4 * q + 2] = a.z;
        r.v[4 * q + 3] = a.w;
      }
    } else if constexpr (N == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      r.v[0] = a.x;
      r.v[1] = a.y;
    } else {
      r.v[0] = __ldg(p);
    }
    return r;
  }
  __device__ static Out put(const Raw& r) {
    if constexpr (N == 1) {
      return __bfloat16_as_ushort(__float2bfloat16_rn(r.v[0]));
    } else {
      unsigned w[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(r.v[2 * i],
                                                       r.v[2 * i + 1]);
        memcpy(&w[i], &h, sizeof(unsigned));
      }
      Out o;
      memcpy(&o, w, sizeof(Out));
      return o;
    }
  }
};

// kStream: a streaming store (st.global.cs)
template <bool kStream, class V>
__device__ __forceinline__ void store_out(V* p, const V& v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// the batch of wide rows
template <class Raw>
struct WideBatch {
  static constexpr int regs =
      sizeof(Raw) < 4 ? 1 : static_cast<int>(sizeof(Raw) / 4);
  static constexpr int value = TK_RAW_REGS / regs < TK_BATCH_MAX
                                   ? TK_RAW_REGS / regs
                                   : TK_BATCH_MAX;
};

// One block per chunk; lg = log2 G; B rows a lane loads before it stores
// (a power of two).
template <class Tin, class Tout, int N, int B>
__global__ void __launch_bounds__(TK_THREADS)
take_rows_kernel(const Tin* __restrict__ table, WindowRows rows, int L,
                 int lg, Tout* __restrict__ out) {
  using M = Move<Tin, Tout, N>;
  using Out = typename M::Out;
  constexpr bool kStream = B > TK_BATCH_NARROW;  // wide rows
  __shared__ int s_row[EC];
  const long long k0 = static_cast<long long>(blockIdx.x) * EC;
  s_row[threadIdx.x] = rows(k0 + threadIdx.x, blockIdx.x);
  __syncthreads();
  const int G = 1 << lg;
  const int g = threadIdx.x >> lg, lane = threadIdx.x & (G - 1);
  const int rs = TK_THREADS >> lg;  // rows one step of the block covers
  Tout* o = out + k0 * L;
  for (int col = lane * N; col < L; col += G * N) {
    for (int s0 = 0; s0 < G; s0 += B) {
      typename M::Raw v[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int r = s0 + b < G ? s_row[(s0 + b) * rs + g] : -1;
        v[b] = typename M::Raw{};
        if (r >= 0) v[b] = M::load(table + static_cast<long long>(r) * L + col);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (s0 + b >= G) break;
        store_out<kStream>(
            reinterpret_cast<Out*>(
                o + static_cast<long long>((s0 + b) * rs + g) * L + col),
            M::put(v[b]));
      }
    }
  }
}

template <class Tin, class Tout, int N, int B>
int launch_take(const Tin* table, WindowRows rows, int n_chunks, int L,
                int lg, Tout* out, cudaStream_t st) {
  take_rows_kernel<Tin, Tout, N, B>
      <<<n_chunks, TK_THREADS, 0, st>>>(table, rows, L, lg, out);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of b rows a lane in flight (1, 2, 4, or 0: the wide
// batch).
template <class Tin, class Tout, int N>
int launch_take_b(int b, const Tin* table, WindowRows rows, int n_chunks,
                  int L, int lg, Tout* out, cudaStream_t st) {
  constexpr int kWide = WideBatch<typename Move<Tin, Tout, N>::Raw>::value;
  switch (b) {
    case 1:
      return launch_take<Tin, Tout, N, 1>(table, rows, n_chunks, L, lg, out,
                                          st);
    case 2:
      return launch_take<Tin, Tout, N, 2>(table, rows, n_chunks, L, lg, out,
                                          st);
    case 4:
      return launch_take<Tin, Tout, N, 4>(table, rows, n_chunks, L, lg, out,
                                          st);
    default:
      return launch_take<Tin, Tout, N, kWide>(table, rows, n_chunks, L, lg,
                                              out, st);
  }
}

// The instantiation of N values a step (the largest of N, N / 2, ... not
// above n).
template <class Tin, class Tout, int N>
int launch_take_n(int n, int b, const Tin* table, WindowRows rows,
                  int n_chunks, int L, int lg, Tout* out, cudaStream_t st) {
  if constexpr (N > 1) {
    if (n < N)
      return launch_take_n<Tin, Tout, N / 2>(n, b, table, rows, n_chunks, L,
                                             lg, out, st);
  }
  return launch_take_b<Tin, Tout, N>(b, table, rows, n_chunks, L, lg, out,
                                     st);
}

// out [n_chunks * 256, L] = the table's rows at the slots of `rows`
// (WindowRows), zeros at dead slots; Tin float, Tout float (a copy) or
// __nv_bfloat16 (rounded). Returns cudaGetLastError() after the launch.
template <class Tin, class Tout>
int launch_take_rows(const Tin* table, WindowRows rows, int n_chunks, int L,
                     Tout* out, void* stream) {
  if (n_chunks <= 0 || L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  // the widest step whose vectors are aligned in the table and the output
  int n = static_cast<int>(16 / sizeof(Tout));
  const auto fits = [&](size_t v) {
    const size_t in_bytes = v * sizeof(Tin) < 16 ? v * sizeof(Tin) : 16;
    return L % v == 0 && o % (v * sizeof(Tout)) == 0 && t % in_bytes == 0;
  };
  while (n > 1 && !fits(static_cast<size_t>(n))) n /= 2;
  int lg = 0;  // G = 2^lg lanes a row: enough for the row's vectors, <= 32
  while ((1 << lg) * n < L && lg < 5) ++lg;
  const int G = 1 << lg;
  // narrow rows: vectors under 16 bytes, or at most TK_BATCH_NARROW of them
  const bool narrow = n * sizeof(Tout) < 16 || G <= TK_BATCH_NARROW;
  const int b = narrow ? (G < TK_BATCH_NARROW ? G : TK_BATCH_NARROW) : 0;
  return launch_take_n<Tin, Tout, 16 / sizeof(Tout)>(n, b, table, rows,
                                                     n_chunks, L, lg, out,
                                                     st);
}

}  // namespace
