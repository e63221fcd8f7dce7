// Device helpers of the first CSC-of-tiles SME walk, walk_column_strip, which
// the v3 prefill kernel (sme_spmm_planes) and the bytecode (v1) kernel run;
// the v3-decode and minifloat-6 (v2) kernels run ordered_partials.cuh.
//
// All four kernels compute, per output column tile j, the SME product
//   acc[m, c] = sum over the tile groups g of column j, in list order, of
//               sum_k x[m, rowtile(g)*128 + k] * W_g[k, c]
// where W_g is the group's weight tile, signed and scaled by 2^row_exp.
// They differ only in how a tile is decoded (a `Tiles` decoder of
// walk_column_strip): v3 splices it from its 1-bit plane bitmaps (bits *
// 2^shift) over the group's slots, v1 reads uint8 codewords, v2 unpacks
// 6-bit minifloats; one slot is one group in v1 and v2.  Every decoded
// value is exact in f32 (v2's is v1's times 2^-(n_bits - squeezed)), and
// every output is summed in one fixed order: a sequential fmaf chain over
// k = 0..127 per group (the partial t_g, never split), then acc += t_g over
// groups in list order from 0.  So the four kernels agree bitwise (v2 up to
// that power of two, which commutes with f32 rounding).  Here one thread
// computes both for its outputs; ordered_partials.cuh computes the t_g of
// one column in parallel and adds them in the same order.  Built without
// fast-math or flush-to-zero, which would break the power-of-two argument.
//
// Layouts (the reference packers', unchanged; bk = bn = 128):
//   v3: planes   u8  [Nt, L, 16, 128]   rows packed MSB first (np.packbits)
//       sign     u8  [nr, Nt, 16, 128]  1 = negative
//       rowscale f32 [nr, Nt, 128]      2^row_exp
//       rowid/shift/last i32 [Nt, L]
//   v1: codes    u8  [Nt, L, 128, 128]
//       sign     u8  [Nt, L, 16, 128]   per slot, rows packed MSB first
//       rowscale f32 [Nt, L, 128]       per slot
//       rowid    i32 [Nt, L]
//   v2: packed   u8  [Nt, L, 128, 96]   4 six-bit codes per 3 bytes, first
//                                       code in the low bits
//       rowscale f32 [Nt, L, 128]       per slot
//       rowid    i32 [Nt, L]
//   nnz i32 [Nt]; slots l >= nnz[j] are padding.
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

// The v3 decoder: a group is the run of planes of one (row, col) tile,
// ending at a `last` slot.  Each thread splices its 16 cells of the strip
// in registers over the group's planes, at most `depth` of them (the most
// significant first), then signs and row-scales them from the dense
// per-tile arrays.
struct PlaneTiles {
  const uint8_t* planes;
  const uint8_t* sign;
  const float* rowscale;
  const int* rowid;
  const int* shift;
  const int* last;
  int nt;
  int depth;
  float cell[16];
  int in_group;

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < 16; ++i) cell[i] = 0.0f;
    in_group = 0;
  }
  __device__ __forceinline__ bool take(size_t slot, int col, int w) {
    if (in_group < depth)
      splice_plane(planes + slot * kTileBytes, col, w,
                   ldexpf(1.0f, shift[slot]), cell);
    ++in_group;
    return last[slot];
  }
  __device__ __forceinline__ void fill(size_t slot, int j, int col, int lane,
                                       int w, float* wtile) {
    const size_t tile = (size_t)rowid[slot] * nt + j;
    finish_group(sign + tile * kTileBytes, rowscale + tile * kTile, col, lane,
                 w, cell, wtile);
    start();
  }
};

// The v1 decoder: each slot is one tile of uint8 codewords with its own
// sign bitmap and 2^row_exp, indexed by the slot (not by rowid).
struct BytecodeTiles {
  const uint8_t* codes;
  const uint8_t* sign;
  const float* rowscale;

  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ bool take(size_t, int, int) { return true; }
  __device__ __forceinline__ void fill(size_t slot, int, int col, int lane,
                                       int w, float* wtile) {
    const uint8_t* tile = codes + slot * kTile * kTile;
    float cell[16];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cell[b * 8 + i] = (float)tile[(8 * (w + 8 * b) + i) * kTile + col];
    finish_group(sign + slot * kTileBytes, rowscale + slot * kTile, col, lane,
                 w, cell, wtile);
  }
};

// One block: column tile j = blockIdx.x / 4, strip blockIdx.x % 4, rows
// [64*blockIdx.y, +64).  Walks column j's list in order up to nnz[j]:
// `tiles.take(slot)` consumes a slot and says whether it closes a tile
// group, whose signed, row-scaled strip `tiles.fill` then writes to shared
// memory for the dot.  Writes acc * colscale (colscale may be null:
// unscaled) into y [M, Nt*128].
template <class Tiles>
__device__ __forceinline__ void walk_column_strip(
    const float* __restrict__ x, int m, int k_pad, Tiles& tiles,
    const float* __restrict__ colscale, const int* __restrict__ rowid,
    const int* __restrict__ nnz, int nt, int L, float* __restrict__ y) {
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
  tiles.start();

  const int n = nnz[j];
  for (int l = 0; l < n; ++l) {
    const size_t slot = (size_t)j * L + l;
    if (tiles.take(slot, col, w)) {
      tiles.fill(slot, j, col, lane, w, wtile);
      __syncthreads();
      tile_dot(x + (size_t)m0 * k_pad + (size_t)rowid[slot] * kTile, k_pad,
               m_rows, wtile, lane, w, acc);
      __syncthreads();
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
