// One corner-turn pass for Hopper (sm_90a): a static row permutation step.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/corner.py::
// _make_permute_kernel (launched by _one_pass_arrays). Same function: output
// row k of tile t = k / 128 is x[lo[t] * 128 + g[k]], where lo[t] is the
// first input tile of the tile's p-tile window and g[k] < p * 128 the row
// within it. A row of a dead tile of the plan (lo = g = 0) reads row 0, as
// the TPU kernel does; its value is never consumed. Rows whose source lay
// outside the capped window carry g = 0 too and are set afterwards by the
// plan's fix-up (ops/corner.py::apply_passes). The values are copied, so
// the result is bit-exact f32 at any L.
//
// The TPU kernel DMAs the tile's p window tiles into VMEM and selects each
// output row with p clamped per-lane takes or a one-hot MXU matmul at
// HIGHEST precision, because Mosaic cannot gather rows. Here one block of
// 128 threads per output tile (the tile count T of a pass may be odd, so
// blocks are tiles, not 256-slot chunks) stages the tile's source rows and
// copies them (slot_rows.cuh: gather_rows_kernel with WindowRows{lo, g,
// p * 128}). The window keeps a tile's reads within p * 128 consecutive
// input rows (p <= 56: 1.8 MB at L = 64), so neighbouring tiles share L2
// lines of the input.
//
// Bound on the H100: bytes: the input rows read once and [T * 128, L]
// floats written, plus the index words (g per row, lo per tile); there is
// no arithmetic.

#include "slot_rows.cuh"

// x [E_in, L] f32; lo [n_tiles] int32; g [>= n_tiles * 128] int32 (the
// plan's [ceil(T / 8), 8, 128] array); out [n_tiles * 128, L] f32. Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int pygat_corner_permute(const float* x, const int* lo,
                                    const int* g, int n_tiles, int p, int L,
                                    float* out, void* stream) {
  return launch_gather_rows<TILE>(x, WindowRows{lo, g, p * TILE}, n_tiles, L,
                                  out, stream);
}
