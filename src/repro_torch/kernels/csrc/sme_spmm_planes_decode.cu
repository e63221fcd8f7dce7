// v3-decode: plane-CSC dequant-GEMV for decode-sized batches (M <= 64).
//
// Replaces the Pallas TPU kernel sme_spmm_planes_decode
// (repro/kernels/sme_spmm/sme_spmm_planes_decode.py, _kernel and its
// pallas_call).  y = (x @ W_codes) * colscale with colscale = scale *
// 2^-n_bits fused into the store, and an optional plane_depth that keeps
// each tile group's `depth` most significant planes (the truncated draft).
//
// Bound on an H100: bytes.  Per call it must read every occupied plane
// bitmap (2 KB per (plane, tile)), the sign bitmap and 2^row_exp of every
// occupied tile, x and colscale, and write y: about 1.1 MB for a 1024x1024
// layer at 7 of 8 planes occupied, 0.3 us at 3.35 TB/s, against 2*M*K*N
// FLOPs that stay far under the f32 rate at M <= 64.
//
// Design: one 256-thread block per (column tile, 32-column strip), so a
// 1024-wide layer launches 8 x 4 blocks and a 2816-wide one 22 x 4 (the
// TPU's one-step-per-column grid would leave most of 132 SMs idle).  A
// block walks its column's list in order directly over rowid/shift/last,
// so it needs no group index; each thread splices its 16 cells of the
// strip in registers, one __syncthreads pair per group publishes the
// signed tile to shared memory for the f32 fmaf dot.  No tensor cores and
// no split-K: the result stays within the 5e-5 relative bound and
// bitwise equal to the prefill kernel.  Latency, not bandwidth, bounds this
// first version: the list walk is serial per block.
#include <climits>

#include "plane_csc.cuh"

namespace {

__global__ void __launch_bounds__(plane_csc::kThreads)
sme_spmm_planes_decode_kernel(const float* x, int m, int k_pad,
                              const uint8_t* planes, const uint8_t* sign,
                              const float* rowscale, const float* colscale,
                              const int* rowid, const int* shift,
                              const int* last, const int* nnz, int nt, int L,
                              int depth, float* y) {
  plane_csc::PlaneTiles tiles{planes, sign, rowscale, rowid, shift, last,
                              nt, depth};
  plane_csc::walk_column_strip(x, m, k_pad, tiles, colscale, rowid, nnz, nt,
                               L, y);
}

}  // namespace

// depth <= 0 means full precision.  Returns cudaGetLastError().
extern "C" int sme_spmm_planes_decode(
    const float* x, int m, int k_pad, const uint8_t* planes,
    const uint8_t* sign, const float* rowscale, const float* colscale,
    const int* rowid, const int* shift, const int* last, const int* nnz,
    int nt, int L, int depth, float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sme_spmm_planes_decode_kernel<<<plane_csc::grid_for(m, nt),
                                  plane_csc::kThreads, 0,
                                  (cudaStream_t)stream>>>(
      x, m, k_pad, planes, sign, rowscale, colscale, rowid, shift, last, nnz,
      nt, L, depth > 0 ? depth : INT_MAX, y);
  return (int)cudaGetLastError();
}
