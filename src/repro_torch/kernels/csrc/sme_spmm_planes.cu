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
// Design: the decode kernel's walk (plane_csc.cuh) with the grid also over
// 64-row M tiles: block (column tile x 32-column strip, M tile).  Every
// block re-splices its strip's weight tiles, which the FLOPs of the dot
// amortise at 64 rows.  Same device helpers, same per-output summation
// order, so it agrees bitwise with the decode kernel.  f32 fmaf on the CUDA
// cores, no tensor cores: TF32 would break the 5e-5 bound.
#include <climits>

#include "plane_csc.cuh"

namespace {

__global__ void __launch_bounds__(plane_csc::kThreads)
sme_spmm_planes_kernel(const float* x, int m, int k_pad, const uint8_t* planes,
                       const uint8_t* sign, const float* rowscale,
                       const int* rowid, const int* shift, const int* last,
                       const int* nnz, int nt, int L, float* y) {
  plane_csc::PlaneTiles tiles{planes, sign, rowscale, rowid, shift, last,
                              nt, INT_MAX};
  plane_csc::walk_column_strip(x, m, k_pad, tiles, nullptr, rowid, nnz, nt, L,
                               y);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int sme_spmm_planes(
    const float* x, int m, int k_pad, const uint8_t* planes,
    const uint8_t* sign, const float* rowscale, const int* rowid,
    const int* shift, const int* last, const int* nnz, int nt, int L,
    float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sme_spmm_planes_kernel<<<plane_csc::grid_for(m, nt), plane_csc::kThreads, 0,
                           (cudaStream_t)stream>>>(
      x, m, k_pad, planes, sign, rowscale, rowid, shift, last, nnz, nt, L, y);
  return (int)cudaGetLastError();
}
