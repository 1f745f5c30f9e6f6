// Fused GATv1 attention forward over the receiver stream, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v1_kernel (launched through _grid_call by _v1_fwd_impl), which
// receives the sender rows pre-gathered and selects with one-hot matmuls.
// Here a block owns a receiver tile and walks the stream itself, which is
// receiver-sorted within each tile: a unit of lanes sums each receiver's
// run of slots in registers, gathering wh[senders[k]], and stores every row
// once (tile_fused.cuh, which describes the kernel and what bounds it).

#include "tile_fused.cuh"

// wh [N_s, H*F], f_dst / bound [n_tiles * 128, H], a_src [H, F], keepq
// [E_s, H] f32; senders [E_s] int32 (the receiver stream's), indexing wh's
// rows: N_s is the receivers' row count on one device, while a hop of the
// ring (pygat_tpu_torch/parallel/partition.py, the counterpart of
// pygat_tpu/ops/fused_stream.py::fused_v1_attention_parts) passes this
// shard's f_dst and bound and a rotated shard or a halo buffer as wh, whose
// row count need not be theirs; row_ptr [n_tiles * 129 + 1]
// int32: the first stream position of each (tile, local row) key
// t * 129 + l; tile_ptr [n_tiles + 1] and split_at [n_split] int32
// (ops/stream.py tile_ranges); max_run the most live slots of one receiver
// (Graph.stream_walk); out [n_tiles * 128, H*F] and den [n_tiles * 128, H]
// f32, every row written; part_out [n_split, 128, H*F] and part_den
// [n_split, 128, H] f32 scratch (unused when n_split is 0). Launches on
// `stream`; returns the first CUDA error, or cudaGetLastError() after the
// launches (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v1(
    const float* wh, const float* f_dst, const float* bound,
    const float* a_src, const float* keepq, const int* senders,
    const int* row_ptr, const int* tile_ptr, const int* split_at,
    int n_tiles, int n_split, int max_run, int H, int F, float alpha,
    float* out, float* den, float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<false>(
      FusedArgs{wh, nullptr, hf, nullptr, f_dst, bound, a_src, keepq,
                row_ptr, tile_ptr, split_at, n_tiles, n_split, H, F, alpha,
                out, den, part_out, part_den, 0, 0, 0},
      ListWalk{senders}, max_run, stream);
}

