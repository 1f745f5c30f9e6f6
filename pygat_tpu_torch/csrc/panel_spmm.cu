// Panel-gather SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/panel.py::_make_spmm_kernel
// (launched by _panel_fwd_impl, 'high' precision). Same function: over the
// receiver stream, out[i] = sum over the slots k with receiver i (r_chunk[c]
// * 128 + r_local[k], c = k / 256) whose panel index g = g_idx[k] is below
// p * 128 of w[k] * x[panel_tiles[r_chunk[c], g / 128] * 128 + g % 128],
// where w[k] = vals[k] if edge_mask[k], else 0. A slot with g == p * 128 is
// dead or overflows its tile's panels and adds nothing here: the caller
// adds the overflow slots in a second pass (the TPU version does that pass
// in XLA, outside its kernel). g is tested before a row is formed: the
// padded columns of panel_tiles hold tile 0.
//
// The TPU kernel DMAs the output tile's p panel tiles into VMEM once per
// tile and selects rows from them with a one-hot matmul. Here the stream
// segment sum of stream_scatter.cuh reads slot k's row through
// slot_rows.cuh's PanelRows and scales it by w[k] as it stages it, so the
// [E_s, L] message array never reaches memory. A tile's rows lie in its
// panels, so on a local graph they come from L2 after the first touch.
//
// Bound on the H100: bytes: x once, out once, per slot its value, mask byte
// and two index words, the panel table; two FLOPs per live slot and column.

#include "stream_scatter.cuh"

// vals [n_chunks * 256] f32; mask [n_chunks * 256] bool; x [n_tiles * 128,
// L] f32; panel_tiles [n_tiles, p] int32; g_idx, r_local [n_chunks * 256]
// int32; r_chunk [n_chunks] int32; out [n_tiles * 128, L] f32. Zeroes out
// and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch.
extern "C" int pygat_panel_spmm(const float* vals, const unsigned char* mask,
                                const float* x, const int* panel_tiles,
                                const int* g_idx, const int* r_local,
                                const int* r_chunk, int n_chunks, int n_tiles,
                                int p, int L, float* out, void* stream) {
  return launch_scatter_rows(x, PanelRows{panel_tiles, r_chunk, g_idx, p},
                             SlotWeights{vals, mask}, r_local, r_chunk,
                             n_chunks, n_tiles, L, out, stream);
}
