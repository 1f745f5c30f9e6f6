// Expand for Hopper (sm_90a): rows of a node table in the order of a
// chunked edge stream.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/large.py::
// _make_expand_kernel (launched by _expand_impl). Same function: slot k of
// chunk c = k / 256 gets x[chunk_tile[c] * 128 + local[k]], and a dead slot
// (local == 128) gets zeros and reads nothing. The values are copied, so
// the result is bit-exact f32. The banded backward uses it for the
// receiver-side operands ([f_dst | bound | g_out | g_den] for GATv1,
// [whi | ub | g_out | g_den] for GATv2) in banded slot order.
//
// The TPU kernel selects the rows from the chunk's one 128-row tile with a
// one-hot matmul at HIGHEST precision, because Mosaic cannot gather rows.
// Here one block per chunk stages the chunk's source rows and copies them
// (slot_rows.cuh: gather_rows_kernel).
//
// Bound on the H100: bytes. It reads each live slot's row once (the rows
// of one chunk lie in one 128-row tile, so they come from L2 after the
// first touch) and writes [E, L] floats; there is no arithmetic.

#include "slot_rows.cuh"

// x [n_tiles * 128, L] f32; local [n_chunks * 256] int32; chunk_tile
// [n_chunks] int32; out [n_chunks * 256, L] f32. Launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int pygat_expand(const float* x, const int* local,
                            const int* chunk_tile, int n_chunks, int L,
                            float* out, void* stream) {
  return launch_gather_rows(x, WindowRows{chunk_tile, local, TILE}, n_chunks,
                            L, out, stream);
}
