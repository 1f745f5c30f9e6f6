// Banded sender sum for Hopper (sm_90a): per-sender segment sum of edge
// data in banded slot order.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_sender_sum_kernel (launched by _banded_sender_sum_direct). Same
// function: out[n, :] = sum of data[k, :] over the live slots k whose
// sender band[k / 256] * 128 + s_loc[k] is n; dead slots (s_loc == w * 128)
// add nothing, and rows that no live slot names are 0. The banded backward
// uses it for dwh (GATv1, L = HF) and [dwhj | dwhi_msg] (GATv2, L = 2 HF).
//
// The TPU kernel walks the chunks in band-sorted order (the plan's bs_band,
// bs_chunk and bs_sloc) and accumulates in w band-indexed VMEM outputs
// folded at the end. This kernel runs on the tile-owner body tile_sum.cuh
// over the plan's sender walk (BandPlan.sender_walk, built on the host with
// the plan): a stream of the live banded slots sorted by sender, whose
// position k reads the banded slot order[k]; the dead slots are in no run.
// tile_sum.cuh notes the layout and what bounds it.

#include "tile_sum.cuh"

// data [n_chunks * 256, L] f32 in banded order; order [positions] int32
// (the banded slot at each position of the sender walk); row_ptr
// [n_tiles * 129 + 1], tile_ptr [n_tiles + 1], split_at [n_split] int32
// (the walk's); out [n_tiles * 128, L] f32; part [n_split, 128, L] f32 (or
// null when n_split is 0). Launches on `stream`; returns the first CUDA
// error, or cudaGetLastError() after the launches.
extern "C" int pygat_banded_sender_sum(const float* data, const int* order,
                                       const int* row_ptr,
                                       const int* tile_ptr,
                                       const int* split_at, int n_tiles,
                                       int n_split, int max_run, int L,
                                       float* out, float* part,
                                       void* stream) {
  return launch_tile_sum(SumArgs{data, order, row_ptr, tile_ptr, split_at,
                                 n_tiles, n_split, L, out, part, 0},
                         max_run, stream);
}
