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
// Design: one C entry point, two device kernels chosen by M, as v2's
// (ordered_partials.cuh, with the BytecodeStrip decoder).
//  * 2*M <= 128: decode_walk with BytecodeStrip<32>: a cluster of up to 8
//    blocks per (column tile, 32-column strip) splits the column's tiles
//    over its ranks (one tile each at 1024 rows); each copies its tile's
//    32-byte codeword and sign row strips, 2^row_exp and x slice with
//    cp.async into a two-stage ring, decodes four codes per 32-bit word and
//    dots only real rows; the partials are added in list order over
//    distributed shared memory.
//  * otherwise: tiled_walk with BytecodeStrip<64>: one block per (column
//    tile, 64-column half, 64-row M tile); each tile half is decoded once
//    per block and reused by all 64 rows, each thread accumulates a 4x4
//    grid of outputs.  One 9.5 KB payload buffer (the next tile's lands
//    during this tile's dot) and a two-stage x ring: 107.5 KB of shared
//    memory, so two blocks share an SM (two payload stages would take
//    117 KB, one block).
// The decoded tile equals v3's spliced tile exactly and each output is one
// fmaf chain per tile added in list order, so the result is bitwise v2's
// and v3's.  No tensor cores: TF32 would break the 5e-5 bound.
#include "ordered_partials.cuh"

namespace {

template <int BN>
ordered_partials::BytecodeStrip<BN> v1_strip(const uint8_t* codes,
                                             const uint8_t* sign,
                                             const float* rowscale,
                                             const int* rowid,
                                             const int* nnz, int L) {
  return {{rowid, nnz, L, nullptr}, codes, sign, rowscale};
}

}  // namespace

// Returns the CUDA error of the launch.
extern "C" int sme_spmm(const float* x, int m, int k_pad, const uint8_t* codes,
                        const uint8_t* sign, const float* rowscale,
                        const int* rowid, const int* nnz, int nt, int L,
                        float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)ordered_partials::launch_by_m(
      v1_strip<32>(codes, sign, rowscale, rowid, nnz, L),
      v1_strip<64>(codes, sign, rowscale, rowid, nnz, L), m, k_pad, nt, L, x,
      y, (cudaStream_t)stream);
}

// Launch shape for these sizes (ordered_partials::report_geometry).
extern "C" int sme_spmm_geometry(int m, int k_pad, int nt, int L, int* out) {
  return ordered_partials::geometry_by_m(
      v1_strip<32>(nullptr, nullptr, nullptr, nullptr, nullptr, L),
      v1_strip<64>(nullptr, nullptr, nullptr, nullptr, nullptr, L), m, k_pad,
      nt, L, out);
}
