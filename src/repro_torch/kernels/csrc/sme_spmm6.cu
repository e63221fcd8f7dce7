// v2: tile-CSC minifloat-6 dequant-matmul, for decode and prefill batches.
//
// Replaces the Pallas TPU kernel sme_spmm6 (repro/kernels/sme_spmm/
// sme_spmm6.py, _kernel through csc_pallas_call in csc_grid.py).  y = x @
// W, unscaled and decoded with squeezed = 0 (the reference backend's
// static argument): the caller applies (y * scale) * 2^-squeezed.
//
// Bound on an H100: per occupied 128x128 tile the kernel must read 12 KB
// of packed codes and 512 B of 2^row_exp (0.78 B per weight, the smallest
// of the three formats): ~0.9 MB, 0.26 us, for a 1024x1024 layer at
// M = 8, where the 2*M*K*N f32 FLOPs (67 TFLOP/s) already take 0.25 us;
// the FLOPs bound it from there up (16 us per 1024x1024 call at M = 512).
//
// Design: one C entry point, two device kernels chosen by M as v3 chooses
// (ordered_partials.cuh).
//  * 2*M <= 128: decode_walk with Minifloat6Strip<32>, as v3-decode: a
//    cluster of up to 8 blocks per (column tile, 32-column strip) splits
//    the column's tiles over its ranks (one tile each at 1024 rows), each
//    copies its tile's 24-byte row strips and x slice with cp.async into a
//    two-stage ring, decodes in 32-bit words and dots only real rows; the
//    partials are added in list order over distributed shared memory.
//  * otherwise: tiled_walk with Minifloat6Strip<64>: one block per (column
//    tile, 64-column half, 64-row M tile), 128 blocks for a 1024x1024 layer
//    at M = 512 and two per SM; each tile half is decoded once per block and
//    reused by all 64 rows, each thread accumulates a 4x4 grid of outputs,
//    and the next tile's 6 KB payload and 32 KB x slice load during the dot.
// The decoded tile is v1's times 2^-(n_bits - squeezed) exactly and each
// output is one fmaf chain per tile added in list order, so after the
// caller's scaling the result is bitwise v1's and v3's.
#include "ordered_partials.cuh"

namespace {

template <int BN>
ordered_partials::Minifloat6Strip<BN> v2_strip(const uint8_t* packed,
                                               const float* rowscale,
                                               const int* rowid,
                                               const int* nnz, int L) {
  return {{rowid, nnz, L, nullptr}, packed, rowscale};
}

}  // namespace

// Returns the CUDA error of the launch.
extern "C" int sme_spmm6(const float* x, int m, int k_pad,
                         const uint8_t* packed, const float* rowscale,
                         const int* rowid, const int* nnz, int nt, int L,
                         float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)ordered_partials::launch_by_m(
      v2_strip<32>(packed, rowscale, rowid, nnz, L),
      v2_strip<64>(packed, rowscale, rowid, nnz, L), m, k_pad, nt, L, x, y,
      (cudaStream_t)stream);
}

// Launch shape for these sizes (ordered_partials::report_geometry).
extern "C" int sme_spmm6_geometry(int m, int k_pad, int nt, int L, int* out) {
  return ordered_partials::geometry_by_m(
      v2_strip<32>(nullptr, nullptr, nullptr, nullptr, L),
      v2_strip<64>(nullptr, nullptr, nullptr, nullptr, L), m, k_pad, nt, L,
      out);
}
