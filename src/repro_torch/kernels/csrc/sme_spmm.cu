// v1: tile-CSC bytecode dequant-matmul, for decode and prefill batches.
//
// Replaces the Pallas TPU kernel sme_spmm (repro/kernels/sme_spmm/
// sme_spmm.py, _kernel through csc_pallas_call in csc_grid.py).  y = x @
// W_codes, unscaled (the reference's n_bits = 0): the caller applies
// (y * scale) * 2^-n_bits, as the reference backend does.
//
// Bound on an H100: per occupied 128x128 tile the kernel must read 16 KB
// of codewords, 2 KB of signs and 512 B of 2^row_exp (1.13 B per weight),
// so at M = 8 bytes bound it (~1.3 MB, 0.38 us, for a 1024x1024 layer);
// from M of about 12 rows up the 2*M*K*N f32 FLOPs on the CUDA cores
// (67 TFLOP/s) do.
//
// Design: the v3 kernels' walk (plane_csc.cuh) with the BytecodeTiles
// decoder: one 256-thread block per (column tile, 32-column strip, 64-row
// M tile) walks the column's tile list in order up to nnz[j]; each thread
// reads its 16 codewords of the slot's strip, signs and row-scales them
// into shared memory, and the f32 fmaf dot runs as in v3.  One kernel
// serves decode and prefill: M need only be a multiple of 8 (rows past m
// are clamped, never stored).  The decoded tile equals v3's spliced tile
// exactly, and the summation order is v3's, so the result is bitwise v3's.
// No tensor cores: TF32 would break the 5e-5 bound.
#include "plane_csc.cuh"

namespace {

__global__ void __launch_bounds__(plane_csc::kThreads)
sme_spmm_kernel(const float* x, int m, int k_pad, const uint8_t* codes,
                const uint8_t* sign, const float* rowscale, const int* rowid,
                const int* nnz, int nt, int L, float* y) {
  plane_csc::BytecodeTiles tiles{codes, sign, rowscale};
  plane_csc::walk_column_strip(x, m, k_pad, tiles, nullptr, rowid, nnz, nt, L,
                               y);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int sme_spmm(const float* x, int m, int k_pad, const uint8_t* codes,
                        const uint8_t* sign, const float* rowscale,
                        const int* rowid, const int* nnz, int nt, int L,
                        float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sme_spmm_kernel<<<plane_csc::grid_for(m, nt), plane_csc::kThreads, 0,
                    (cudaStream_t)stream>>>(x, m, k_pad, codes, sign, rowscale,
                                            rowid, nnz, nt, L, y);
  return (int)cudaGetLastError();
}
