// Banded take for Hopper (sm_90a): sender rows of a node table in banded
// slot order.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_banded_kernel (launched by _banded_take_impl, `exact` mode). Same
// function: slot k of chunk c = k / 256 gets table[band[c] * 128 +
// s_loc[k]], and a dead slot (s_loc == w * 128) gets zeros. The dead test
// comes before the row is formed: a dead slot of a chunk on the last band
// would name row N_pad, one past the table. The values are copied, so the
// result is bit-exact f32. The banded backward uses it to recompute the
// gathered sender rows (wh for GATv1, [whj | whi] for GATv2).
//
// The TPU kernel DMAs the chunk's w window tiles into VMEM and selects rows
// with w one-hot matmuls, because Mosaic cannot gather rows. Here one block
// per chunk moves the chunk's rows as 16-byte vectors, a group of lanes a
// row, several rows in flight a lane, the output by streaming stores
// (take_rows.cuh); the rows of one chunk lie in its w-tile window (w * 128
// rows), so after the first touch they come from L2.
//
// Bound on the H100: bytes: the table once, [E_b, L] floats written, the
// index words; there is no arithmetic.

#include "take_rows.cuh"

// table [n_tiles * 128, L] f32; band [n_chunks] int32; s_loc
// [n_chunks * 256] int32; out [n_chunks * 256, L] f32. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int pygat_banded_take(const float* table, const int* band,
                                 const int* s_loc, int n_chunks, int w, int L,
                                 float* out, void* stream) {
  return launch_take_rows(table, WindowRows{band, s_loc, w * TILE}, n_chunks,
                          L, out, stream);
}
