// Banded take rounded to bf16 for Hopper (sm_90a): the one-limb
// instantiation of banded_take.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_banded_kernel at exact=False (launched by _banded_take_impl under
// precision="fastest"), which casts the table to bf16 and selects its rows
// with one bf16 one-hot pass, so every row comes out as the table's bf16
// value. Here the kernel reads the f32 table and rounds each value it moves
// in registers (to nearest, ties to even, as Tensor.to(torch.bfloat16)),
// so the wrapper makes no bf16 copy of the table: slot k of chunk c = k /
// 256 gets table[band[c] * 128 + s_loc[k]] rounded, and a dead slot (s_loc
// == w * 128) gets zeros, the dead test before the row is formed, as
// banded_take.cu, on the same row gather (take_rows.cuh: 16-byte output
// vectors, each from two 16-byte loads of f32, where L and the pointers
// allow). The banded backward under "fastest" recomputes its
// sender rows with it (wh for GATv1, [whj | whi] for GATv2).
//
// Bound on the H100: bytes: the f32 table once, [E_b, L] bf16 written, the
// index words; one rounding a value.

#include <cuda_bf16.h>

#include "take_rows.cuh"

// table [n_tiles * 128, L] f32; band [n_chunks] int32; s_loc
// [n_chunks * 256] int32; out [n_chunks * 256, L] bf16. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int pygat_banded_take_bf16(const float* table, const int* band,
                                      const int* s_loc, int n_chunks, int w,
                                      int L, __nv_bfloat16* out,
                                      void* stream) {
  return launch_take_rows(table, WindowRows{band, s_loc, w * TILE}, n_chunks,
                          L, out, stream);
}
