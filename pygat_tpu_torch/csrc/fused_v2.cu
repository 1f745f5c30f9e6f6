// Fused GATv2 attention forward over the receiver stream, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v2_kernel (launched through _grid_call by _v2_fwd_impl), which
// receives whj and whi pre-gathered at the senders and selects with one-hot
// matmuls. Here a block owns a receiver tile and walks the stream itself,
// which is receiver-sorted within each tile: a unit of lanes keeps the
// receiver's whi row in registers for its run, gathers whj[senders[k]] and
// whi[senders[k]], sums the run in registers and stores every row once
// (tile_fused.cuh, which describes the kernel and what bounds it).

#include "tile_fused.cuh"

// whi [n_tiles * 128, H*F] (the receiver's rows, in the logit), whi_s and
// whj [N_s, H*F] (the sender's rows: the message and the logit's), ub
// [n_tiles * 128, H], a [H, F], keepq [E_s, H] f32; senders [E_s] int32
// (the receiver stream's), indexing whi_s and whj. On one device whi_s is
// whi; a hop of the ring (pygat_tpu_torch/parallel/partition.py, the
// counterpart of pygat_tpu/ops/fused_stream.py::fused_v2_attention_parts)
// passes this shard's whi and ub and a rotated shard's or a halo buffer's
// whi_s and whj, whose row count need not be theirs. row_ptr
// [n_tiles * 129 + 1] int32: the first stream position of each (tile, local
// row) key t * 129 + l; tile_ptr [n_tiles + 1] and split_at [n_split] int32
// (ops/stream.py tile_ranges); max_run the most live slots of one receiver
// (Graph.stream_walk); out [n_tiles * 128, H*F] and den [n_tiles * 128, H]
// f32, every row written; part_out [n_split, 128, H*F] and part_den
// [n_split, 128, H] f32 scratch (unused when n_split is 0). Launches on
// `stream`; returns the first CUDA error, or cudaGetLastError() after the
// launches (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v2(
    const float* whi, const float* whi_s, const float* whj, const float* ub,
    const float* a, const float* keepq, const int* senders, const int* row_ptr,
    const int* tile_ptr, const int* split_at, int n_tiles, int n_split,
    int max_run, int H, int F, float alpha, float* out, float* den,
    float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<true>(
      FusedArgs{whj, whi_s, hf, whi, nullptr, ub, a, keepq, row_ptr, tile_ptr,
                split_at, n_tiles, n_split, H, F, alpha, out, den, part_out,
                part_den, 0, 0, 0},
      ListWalk{senders}, max_run, stream);
}

