// Fused GATv1 attention forward over the receiver stream with a pre-built
// sender window, for Hopper (sm_90a): the corner path's forward. Replaces
// the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::_make_v1_kernel as
// pygat_tpu/ops/fused_corner.py launches it (through _grid_call) over the
// window that the CSC expand and the corner-turn passes built; the kernel
// and what bounds it are described in fused_v1.cuh. Slot k's sender row is
// row k of the window (slot_rows.cuh: SlotRows), so the kernel gathers
// nothing by edge index.

#include "fused_v1.cuh"

// win [E_s, H*F] (row k: slot k's sender row of wh), f_dst / bound [N, H],
// a_src [H, F], keepq [E_s, H] f32; local [E_s] int32; chunk_tile
// [n_chunks] int32; out [n_tiles * 128, H*F] and den [n_tiles * 128, H]
// f32. Zeroes out and den and launches on `stream`; returns the first CUDA
// error, or cudaGetLastError() after the launch (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v1_window(const float* win, const float* f_dst,
                                     const float* bound, const float* a_src,
                                     const float* keepq, const int* local,
                                     const int* chunk_tile, int n_chunks,
                                     int n_tiles, int H, int F, float alpha,
                                     float* out, float* den, void* stream) {
  return launch_fused_v1(win, f_dst, bound, a_src, keepq, SlotRows{}, local,
                         chunk_tile, n_chunks, n_tiles, H, F, alpha, out, den,
                         stream);
}
