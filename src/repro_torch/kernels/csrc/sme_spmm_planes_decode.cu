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
// FLOPs that stay far under the f32 rate at M <= 64.  So the call is
// latency-bound: what counts is how few dependent steps stand between the
// launch and the last store.
//
// Design (ordered_partials.cuh, decode_walk with PlaneStrip): a cluster of
// up to 8 blocks per (column tile, 32-column strip) splits the column's
// tile groups over its ranks, so a 1024x1024 layer launches 8 x 4 x 8 = 256
// blocks and each computes one group (a 2816-row wo three).  Each block
// finds the group boundaries itself (a scan of `last`, no host index),
// copies a group's plane strips, sign strip, 2^row_exp and x slice with
// cp.async into a two-stage ring (the next group in flight), splices the
// planes as integers (exact), and runs the 128-term fmaf dot with each
// thread on its own output rows only (M bucketed to 8/16/32/64).  The
// partials stay in shared memory; after cluster.sync() they are added in
// list order through distributed shared memory.  No tensor cores and no
// split of a partial's chain: the result is bitwise the prefill kernel's.
#include "ordered_partials.cuh"

// depth <= 0 means full precision.  Returns the CUDA error of the launch.
extern "C" int sme_spmm_planes_decode(
    const float* x, int m, int k_pad, const uint8_t* planes,
    const uint8_t* sign, const float* rowscale, const float* colscale,
    const int* rowid, const int* shift, const int* last, const int* nnz,
    int nt, int L, int depth, float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)ordered_partials::launch_decode(
      ordered_partials::plane_strip<32>(planes, sign, rowscale, rowid, shift,
                                        last, nnz, nt, L, depth),
      m, k_pad, nt, L, x, colscale, y, (cudaStream_t)stream);
}

// Launch shape for these sizes (ordered_partials::report_geometry).
extern "C" int sme_spmm_planes_decode_geometry(int m, int k_pad, int nt,
                                               int L, int depth, int* out) {
  return ordered_partials::decode_geometry(
      ordered_partials::plane_strip<32>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nt, L,
                                        depth),
      m, k_pad, nt, L, out);
}
