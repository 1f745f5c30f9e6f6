// Fused banded SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_spmm_banded_kernel (launched by _spmm_banded_fused_impl, 'high'
// precision). Same function: out[i] = sum over the slots k with receiver i
// of vals[k] * x[band[c] * 128 + s_loc[k]] (c = k / 256), where the receiver
// of slot k is r_chunk[c] * 128 + r_local[k]; a slot with s_loc >= w * 128
// or r_local == 128 is dead and adds nothing. The dead test comes before
// the row is formed: a dead slot of a chunk on the last band would name row
// N_pad, one past the table.
//
// The TPU kernel DMAs the chunk's w window tiles into VMEM, selects and
// scales rows with a vals-weighted one-hot matmul and scatters them with
// the receiver one-hot. Here the stream segment sum of stream_scatter.cuh
// reads slot k's row through slot_rows.cuh's WindowRows{band, s_loc, w*128}
// and scales it by vals[k] as it stages it, so the [E_b, L] message array
// of the two-pass form (banded_take, then stream_scatter) never reaches
// memory. A chunk's rows lie in its w-tile window (w * 128 rows), so after
// the first touch they come from L2.
//
// Bound on the H100: bytes: x once, out once, per slot its value and two
// index words; two FLOPs per live slot and column.

#include "stream_scatter.cuh"

// vals [n_chunks * 256] f32; x [n_tiles * 128, L] f32; band, r_chunk
// [n_chunks] int32; s_loc, r_local [n_chunks * 256] int32; out
// [n_tiles * 128, L] f32. Zeroes out and launches on `stream`; returns the
// first CUDA error, or cudaGetLastError() after the launch.
extern "C" int pygat_spmm_banded(const float* vals, const float* x,
                                 const int* band, const int* s_loc,
                                 const int* r_local, const int* r_chunk,
                                 int n_chunks, int n_tiles, int w, int L,
                                 float* out, void* stream) {
  return launch_scatter_rows(x, WindowRows{band, s_loc, w * TILE},
                             SlotWeights{vals, nullptr}, r_local, r_chunk,
                             n_chunks, n_tiles, L, out, stream);
}
