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
// the FLOPs bound it from there up.
//
// Design: the v3 kernels' walk (plane_csc.cuh) with the Minifloat6Tiles
// decoder: one 256-thread block per (column tile, 32-column strip, 64-row
// M tile) walks the column's tile list in order up to nnz[j]; each thread
// unpacks its 16 six-bit codes of the slot's strip from their 3-byte
// groups (24 bytes per row of a strip) in 32-bit integers, decodes
// (e > 0) * s * (4 + m) * 2^-(e + 2), row-scales into shared memory, and the
// f32 fmaf dot runs as in v3.  One kernel serves decode and prefill (M a
// multiple of 8).  The decoded tile is v1's times 2^-(n_bits - squeezed)
// exactly and the summation order is v1's, so after the caller's scaling
// the result is bitwise v1's and v3's.
#include "plane_csc.cuh"

namespace {

__global__ void __launch_bounds__(plane_csc::kThreads)
sme_spmm6_kernel(const float* x, int m, int k_pad, const uint8_t* packed,
                 const float* rowscale, const int* rowid, const int* nnz,
                 int nt, int L, float* y) {
  plane_csc::Minifloat6Tiles tiles{packed, rowscale};
  plane_csc::walk_column_strip(x, m, k_pad, tiles, nullptr, rowid, nnz, nt, L,
                               y);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int sme_spmm6(const float* x, int m, int k_pad,
                         const uint8_t* packed, const float* rowscale,
                         const int* rowid, const int* nnz, int nt, int L,
                         float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sme_spmm6_kernel<<<plane_csc::grid_for(m, nt), plane_csc::kThreads, 0,
                     (cudaStream_t)stream>>>(x, m, k_pad, packed, rowscale,
                                             rowid, nnz, nt, L, y);
  return (int)cudaGetLastError();
}
