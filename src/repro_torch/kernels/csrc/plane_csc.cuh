// Device helpers shared by the two plane-CSC (v3) kernels.
//
// Both kernels compute, per output column tile j, the SME product
//   acc[m, c] = sum over the tile groups g of column j, in list order, of
//               sum_k x[m, rowtile(g)*128 + k] * W_g[k, c]
// where W_g is the group's codeword tile spliced from its 1-bit plane
// bitmaps (bits * 2^shift, exact in f32), signed and scaled by 2^row_exp.
// Every output is summed by one thread in one fixed order: a sequential
// fmaf chain over k = 0..127 per group, then acc += t over groups.  The
// decode and prefill kernels run this same walk, so they agree bitwise.
// No split-K: blocks split output columns and M rows only.
//
// Layouts (the reference packer's, unchanged; bk = bn = 128):
//   planes   u8  [Nt, L, 16, 128]   rows packed MSB first (np.packbits)
//   sign     u8  [nr, Nt, 16, 128]  1 = negative
//   rowscale f32 [nr, Nt, 128]      2^row_exp
//   rowid/shift/last i32 [Nt, L], nnz i32 [Nt]; slots l >= nnz[j] are padding
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace plane_csc {

constexpr int kTile = 128;                  // bk = bn
constexpr int kTileBytes = kTile / 8 * kTile;
constexpr int kStrip = 32;                  // output columns per block
constexpr int kStrips = kTile / kStrip;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;           // M rows per block
constexpr int kAcc = kRowsPerBlock / kWarps;  // outputs per thread

// Splice one plane's strip into the thread's 16 codeword cells.  Thread
// (warp w, lane) owns packed bytes (w, col) and (w + 8, col), i.e. rows
// 8*w + i and 8*(w + 8) + i of column col.
__device__ __forceinline__ void splice_plane(const uint8_t* plane, int col,
                                             int w, float bitval,
                                             float (&cell)[16]) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const unsigned byte = plane[(w + 8 * b) * kTile + col];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cell[b * 8 + i] += ((byte >> (7 - i)) & 1u) ? bitval : 0.0f;
  }
}

// Sign and 2^row_exp the spliced cells into the shared weight strip
// [128][32]; both factors are exact, so the order of the products is free.
__device__ __forceinline__ void finish_group(const uint8_t* sign,
                                             const float* rowscale, int col,
                                             int lane, int w,
                                             const float (&cell)[16],
                                             float* wtile) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const unsigned byte = sign[(w + 8 * b) * kTile + col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * (w + 8 * b) + i;
      const float s = ((byte >> (7 - i)) & 1u) ? -1.0f : 1.0f;
      wtile[r * kStrip + lane] = cell[b * 8 + i] * s * rowscale[r];
    }
  }
}

// acc[a] += sum_k x[m_a, k] * wtile[k, lane] for rows m_a = w + 8a, summed
// as one sequential fmaf chain per output.  Rows past m_rows read the last
// valid row and are never stored.
__device__ __forceinline__ void tile_dot(const float* xtile, int k_pad,
                                         int m_rows, const float* wtile,
                                         int lane, int w,
                                         float (&acc)[kAcc]) {
  const float* xr[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
    xr[a] = xtile + (size_t)min(w + kWarps * a, m_rows - 1) * k_pad;
  float t[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) t[a] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float wk = wtile[k * kStrip + lane];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) t[a] = fmaf(xr[a][k], wk, t[a]);
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = __fadd_rn(acc[a], t[a]);
}

// One block: column tile j = blockIdx.x / 4, strip blockIdx.x % 4, rows
// [64*blockIdx.y, +64).  Walks column j's plane list in order; each group
// splices at most `depth` planes (its most significant ones).  Writes
// acc * colscale (colscale may be null: unscaled) into y [M, Nt*128].
__device__ __forceinline__ void walk_column_strip(
    const float* __restrict__ x, int m, int k_pad,
    const uint8_t* __restrict__ planes, const uint8_t* __restrict__ sign,
    const float* __restrict__ rowscale, const float* __restrict__ colscale,
    const int* __restrict__ rowid, const int* __restrict__ shift,
    const int* __restrict__ last, const int* __restrict__ nnz, int nt, int L,
    int depth, float* __restrict__ y) {
  __shared__ float wtile[kTile * kStrip];
  const int j = blockIdx.x / kStrips;
  const int col0 = (blockIdx.x % kStrips) * kStrip;
  const int m0 = blockIdx.y * kRowsPerBlock;
  const int m_rows = min(kRowsPerBlock, m - m0);
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int col = col0 + lane;

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
  float cell[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) cell[i] = 0.0f;

  const int n = nnz[j];
  int in_group = 0;
  for (int l = 0; l < n; ++l) {
    const size_t slot = (size_t)j * L + l;
    if (in_group < depth)
      splice_plane(planes + slot * kTileBytes, col, w,
                   ldexpf(1.0f, shift[slot]), cell);
    ++in_group;
    if (last[slot]) {
      const size_t tile = (size_t)rowid[slot] * nt + j;
      finish_group(sign + tile * kTileBytes, rowscale + tile * kTile, col,
                   lane, w, cell, wtile);
      __syncthreads();
      tile_dot(x + (size_t)m0 * k_pad + (size_t)rowid[slot] * kTile, k_pad,
               m_rows, wtile, lane, w, acc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i) cell[i] = 0.0f;
      in_group = 0;
    }
  }

  const float cs = colscale ? colscale[(size_t)j * kTile + col] : 1.0f;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int mr = w + kWarps * a;
    if (mr < m_rows) {
      const float v = colscale ? __fmul_rn(acc[a], cs) : acc[a];
      y[(size_t)(m0 + mr) * nt * kTile + (size_t)j * kTile + col] = v;
    }
  }
}

inline dim3 grid_for(int m, int nt) {
  return dim3(nt * kStrips, (m + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace plane_csc
