// v3: plane-CSC dequant-matmul for prefill-sized batches.
//
// Replaces the Pallas TPU kernel sme_spmm_planes
// (repro/kernels/sme_spmm/sme_spmm_planes.py, _kernel through
// csc_pallas_call in csc_grid.py).  y = x @ W_codes, unscaled: the caller
// applies (y * scale) * 2^-n_bits, as the reference wrapper does.
//
// Bound on an H100: at prefill sizes (M of a few hundred rows) the bytes
// are the same ~1-3 MB per layer as at decode while the work grows as
// 2*M*K*N; in f32 without tensor cores (67 TFLOP/s) the FLOPs set the
// bound from M of about 100 rows up.
//
// Design: tiled_walk with PlaneStrip<64> (ordered_partials.cuh), as v1 and
// v2 run above decode sizes: one block per (column tile, 64-column half,
// 64-row M tile), 128 blocks for a 1024x1024 layer at M = 512.  The block
// scans the column's plane list for its tile groups (as the decode
// kernel), copies a group's plane strips, sign strip and 2^row_exp into one
// payload buffer and its x slice into a two-stage ring with cp.async,
// splices the planes once as integers (exact) and reuses the tile half for
// all 64 rows, each thread accumulating a 4x4 grid of outputs.  Up to 16
// planes per group are staged (codes have at most 16 bits; a deeper group
// traps): about 116 KB of shared memory at 56-slot lists, one block per SM.
// One fmaf chain per group, groups added in list order: bitwise the decode
// kernel's, v1's and v2's.  No tensor cores: TF32 would break the 5e-5
// bound.
#include "ordered_partials.cuh"

// Returns the CUDA error of the launch.
extern "C" int sme_spmm_planes(
    const float* x, int m, int k_pad, const uint8_t* planes,
    const uint8_t* sign, const float* rowscale, const int* rowid,
    const int* shift, const int* last, const int* nnz, int nt, int L,
    float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)ordered_partials::launch_tiled(
      ordered_partials::plane_strip<64>(planes, sign, rowscale, rowid, shift,
                                        last, nnz, nt, L, 0),
      m, k_pad, nt, x, y, (cudaStream_t)stream);
}

// Launch shape for these sizes (ordered_partials::report_geometry).
extern "C" int sme_spmm_planes_geometry(int m, int k_pad, int nt, int L,
                                        int* out) {
  (void)k_pad;
  return ordered_partials::tiled_geometry(
      ordered_partials::plane_strip<64>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nt, L, 0),
      m, nt, out);
}
