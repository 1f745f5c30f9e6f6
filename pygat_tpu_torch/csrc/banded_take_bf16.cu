// Banded take of a bf16 table for Hopper (sm_90a): the one-limb
// instantiation of banded_take.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_banded_kernel at exact=False (launched by _banded_take_impl under
// precision="fastest"), which casts the table to bf16 and selects its rows
// with one bf16 one-hot pass, so every row comes out as the table's bf16
// value. Here the wrapper (ops/banded.py banded_take) makes that bf16 copy
// of the table, and the row gather of slot_rows.cuh copies its rows: slot
// k of chunk c = k / 256 gets table[band[c] * 128 + s_loc[k]], and a dead
// slot (s_loc == w * 128) gets zeros, the dead test before the row is
// formed, as banded_take.cu. 2 bytes a value where banded_take.cu moves 4;
// the copy is element by element, so rows of odd length (L = 7, 14) need
// no alignment. The banded backward under "fastest" recomputes its sender
// rows with it (wh for GATv1, [whj | whi] for GATv2).
//
// Bound on the H100: bytes: the bf16 table once, [E_b, L] bf16 written,
// the index words; there is no arithmetic.

#include <cuda_bf16.h>

#include "slot_rows.cuh"

// table [n_tiles * 128, L] bf16; band [n_chunks] int32; s_loc
// [n_chunks * 256] int32; out [n_chunks * 256, L] bf16. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int pygat_banded_take_bf16(const __nv_bfloat16* table,
                                      const int* band, const int* s_loc,
                                      int n_chunks, int w, int L,
                                      __nv_bfloat16* out, void* stream) {
  return launch_gather_rows(table, WindowRows{band, s_loc, w * TILE},
                            n_chunks, L, out, stream);
}
