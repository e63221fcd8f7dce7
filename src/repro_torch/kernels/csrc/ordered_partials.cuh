// Device walks of the four CSC-of-tiles SME kernels (v3-decode, v3 prefill,
// v1 bytecode, v2 minifloat-6), on the ordered-partials contract.
//
// All four compute, per output column tile j, the SME product
//   acc[m, c] = sum over the tile groups g of column j, in list order, of
//               sum_k x[m, rowtile(g)*128 + k] * W_g[k, c]
// where W_g is the group's weight tile, signed and scaled by 2^row_exp.
// They differ only in how a tile is decoded (a decoder below): v3 splices
// it from its 1-bit plane bitmaps (bits * 2^shift) over the group's slots,
// v1 reads uint8 codewords, v2 unpacks 6-bit minifloats; one slot is one
// group in v1 and v2.  Every decoded value is exact in f32 (v2's is v1's
// times 2^-(n_bits - squeezed)), and the contract fixes only two things per
// output (m, c):
//   t_g = one sequential fmaf chain over k = 0..127 from 0 (group g's dot);
//   acc = ((0 + t_0) + t_1) + ... in list order, each add __fadd_rn.
// So groups may be computed anywhere, in any order, as long as each t_g is
// kept whole and the t_g are added in list order, and the four kernels
// agree bitwise (v2 up to that power of two, which commutes with f32
// rounding).  Built without fast-math or flush-to-zero, which would break
// the power-of-two argument; no tensor cores, which would reorder a chain.
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
//
// decode_walk (decode-sized M: at most 8 rows per warp, 64 per block; a
// larger M takes more row tiles): a thread-block cluster of `cs` blocks per
// (column tile, 32-column strip, 64-row M tile).  Rank r
// computes groups r, r + cs, ... and keeps each partial t_g [MB][32] in its
// shared memory; after cluster.sync() every rank reads a share of the
// outputs' partials from all ranks through distributed shared memory and
// adds them in list order.  A thread owns output rows w + 8a (a < MR) of
// column `lane`: MB = 8 * MR rows are the padded M, so no thread computes a
// clamped row.  Group boundaries (v3: runs ending at last == 1) are found
// in the kernel by a block scan of the column's list.
//
// tiled_walk (prefill): one block per (column tile, 64-column half, 64-row
// M tile) walks the list in order; each group's tile half is decoded once
// into shared memory and reused by all 64 rows; each thread holds a 4x4
// grid of outputs, each its own fmaf chain per group, then acc += t.
//
// Both walks stage a group's payload and its x slice with cp.async into a
// ring of two stages: group i + 1 (of the block) is in flight while group
// i is decoded and dotted (decode_walk keeps one stage when each rank has
// one group).  A decoder whose kPayloadStages is 1 keeps one payload buffer
// in tiled_walk: group i + 1's payload is issued once group i is decoded,
// and lands during group i's dot, so two blocks fit an SM.  Decoders
// (PlaneStrip for v3, BytecodeStrip for v1, Minifloat6Strip for v2) issue a
// group's payload copies and decode it into the signed, row-scaled f32
// strip [128][BN] (row stride BN + 4: the padding spreads the decode's
// row-wise stores over the banks).
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace ordered_partials {

namespace cg = cooperative_groups;

constexpr int kTile = 128;          // bk = bn
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;          // decode_walk: columns per block
constexpr int kStrips = kTile / kStrip;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxPlanes = 16;      // planes of a group: codes have <= 16 bits
constexpr int kBM = 64;             // tiled_walk: rows per block
constexpr int kBN = 64;             // tiled_walk: columns per block
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; with ok == false the destination is zero-filled, nothing read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// Stage rows [m0, m0 + rows) of x's 128 columns of row tile rt into xs
// [rows][128] (rows past m zero-filled).  kSwizzle stores float4 chunk c
// of row r at c ^ ((r >> 2) & 7), so that tiled_walk's two row groups per
// warp read different banks.
template <bool kSwizzle>
__device__ __forceinline__ void issue_x(float* xs, const float* x, int m,
                                        int m0, int rows, int k_pad, int rt) {
  for (int q = threadIdx.x; q < rows * 32; q += kThreads) {
    const int r = q >> 5, c = q & 31;
    const int pc = kSwizzle ? (c ^ ((r >> 2) & 7)) : c;
    const bool ok = m0 + r < m;
    const float* src =
        ok ? x + (size_t)(m0 + r) * k_pad + (size_t)rt * kTile + 4 * c : x;
    cp_async16(xs + r * kTile + 4 * pc, src, ok);
  }
}

// ---- decoders -------------------------------------------------------------

// v3: a group is the run of plane bitmaps of one (row, col) tile, most
// significant first, ending at a `last` slot; at most `depth` of them are
// spliced.  Stage: `cap` plane strips [16][BN] B, the tile's sign strip
// [16][BN] B, its 2^row_exp [128] f32.  Decode: thread (r, h) ORs bit
// 7 - r % 8 of its BN / 2 bytes of packed row r / 8, 16 columns per part,
// into two 16-bit lanes per word (bits << shift, shift < 16: exact integer
// codes), then writes code * sign * 2^row_exp.  PlaneStrip<32> serves
// decode_walk, PlaneStrip<64> tiled_walk.
template <int BN>
struct PlaneStrip {
  static constexpr int kBN = BN;
  static constexpr int kWS = BN + 4;
  static constexpr int kPayloadStages = 1;
  static constexpr int kPlaneB = 16 * BN;       // one plane's strip
  static constexpr int kLogC = BN == 64 ? 2 : 1;  // 16-byte pieces per row
  static constexpr int kLogBN = kLogC + 4;
  static_assert(BN == 32 || BN == 64, "32- or 64-column strips");
  const uint8_t* planes;
  const uint8_t* sign;
  const float* rowscale;
  const int* rowid;
  const int* shift;
  const int* last;
  const int* nnz;
  int nt, L, depth, cap;
  int* gstart;   // shared: first slot of group g; gstart[G] = nnz
  int* grow;     // shared: row tile of group g
  int* gshift;   // shared: shift of slot l

  __host__ __device__ static size_t meta_bytes(int L) {
    return ((size_t)(3 * L + 1 + kWarps) * 4 + 15) / 16 * 16;
  }
  __host__ __device__ size_t payload_bytes() const {
    return (size_t)cap * kPlaneB + kPlaneB + 512;
  }

  // Scan column j's list into the shared group index; returns G.  A list
  // past L, or a group deeper than the `cap` staged planes, traps (the call
  // raises) rather than lose slots.
  __device__ int prepare(int j, int* meta) {
    gstart = meta;
    grow = meta + L + 1;
    gshift = meta + 2 * L + 1;
    int* wsum = meta + 3 * L + 1;
    const int n = nnz[j];
    if (n < 0 || n > L) __trap();
    const size_t base = (size_t)j * L;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int count = 0;
    for (int l0 = 0; l0 < L; l0 += kThreads) {
      const int l = l0 + threadIdx.x;
      // every padded slot exists, so these loads need not wait for nnz
      const int prev = (l > 0 && l < L) ? last[base + l - 1] : 1;
      const int row = l < L ? rowid[base + l] : 0;
      if (l < L) gshift[l] = shift[base + l];
      const bool start = l < n && prev != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, start);
      if (lane == 0) wsum[w] = __popc(ball);
      __syncthreads();
      int before = count, total = 0;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        before += q < w ? wsum[q] : 0;
        total += wsum[q];
      }
      if (start) {
        const int g = before + __popc(ball & ((1u << lane) - 1u));
        gstart[g] = l;
        grow[g] = row;
      }
      count += total;
      __syncthreads();
    }
    if (threadIdx.x == 0) gstart[count] = n;
    __syncthreads();
    for (int g = threadIdx.x; g < count; g += kThreads)
      if (min(gstart[g + 1] - gstart[g], depth) > cap) __trap();
    return count;
  }

  __device__ int row_tile(int, int g) const { return grow[g]; }

  __device__ int planes_of(int g) const {
    return min(min(gstart[g + 1] - gstart[g], depth), cap);
  }

  __device__ void issue(int j, int col0, int g, uint8_t* st) const {
    const int s0 = gstart[g], cnt = planes_of(g);
    const size_t tile = (size_t)grow[g] * nt + j;
    const uint8_t* pl = planes + ((size_t)j * L + s0) * (16 * kTile) + col0;
    uint8_t* sgn = st + cap * kPlaneB;
    constexpr int kC = 1 << kLogC;
    for (int q = threadIdx.x; q < cnt * BN + BN + 32; q += kThreads) {
      if (q < cnt * BN) {
        const int p = q >> kLogBN, pr = (q >> kLogC) & 15, h = q & (kC - 1);
        cp_async16(st + p * kPlaneB + pr * BN + h * 16,
                   pl + (size_t)p * (16 * kTile) + pr * kTile + h * 16);
      } else if (q < cnt * BN + BN) {
        const int pr = (q - cnt * BN) >> kLogC, h = q & (kC - 1);
        cp_async16(sgn + pr * BN + h * 16,
                   sign + (tile * 16 + pr) * kTile + col0 + h * 16);
      } else {
        const int c = q - cnt * BN - BN;
        cp_async16(sgn + kPlaneB + c * 16, rowscale + tile * kTile + 4 * c);
      }
    }
  }

  __device__ void decode(const uint8_t* st, int g, float* ws) const {
    const int r = threadIdx.x & 127, h = threadIdx.x >> 7;
    const int s0 = gstart[g], cnt = planes_of(g);
    const int bs = 7 - (r & 7);
#pragma unroll
    for (int part = 0; part < BN / 32; ++part) {
      const int off = (r >> 3) * BN + h * (BN / 2) + 16 * part;
      uint32_t ev[4] = {0u, 0u, 0u, 0u}, od[4] = {0u, 0u, 0u, 0u};
      for (int p = 0; p < cnt; ++p) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + p * kPlaneB + off);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
        const int sh = gshift[s0 + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t t = (u[q] >> bs) & 0x01010101u;   // byte b -> bit 8b
          ev[q] |= (t & 0x00010001u) << sh;                // columns 4q, 4q+2
          od[q] |= ((t >> 8) & 0x00010001u) << sh;         // columns 4q+1, 4q+3
        }
      }
      const uint4 sv =
          *reinterpret_cast<const uint4*>(st + cap * kPlaneB + off);
      const uint32_t su[4] = {sv.x, sv.y, sv.z, sv.w};
      const float rs =
          reinterpret_cast<const float*>(st + cap * kPlaneB + kPlaneB)[r];
      float out[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t lanes = (b & 1) ? od[q] : ev[q];
          const float cell = (float)((lanes >> (16 * (b >> 1))) & 0xffffu);
          const float s = ((su[q] >> (8 * b + bs)) & 1u) ? -1.0f : 1.0f;
          out[4 * q + b] = __fmul_rn(__fmul_rn(cell, s), rs);
        }
      }
      store16(ws + r * kWS + h * (BN / 2) + 16 * part, out);
    }
  }
};

// The v3 decoder of one call: `depth` <= 0 is full precision.  Groups hold
// at most 16 planes (codes have at most 16 bits), so `cap` = min(16, L,
// depth) planes are staged.
template <int BN>
inline PlaneStrip<BN> plane_strip(const uint8_t* planes, const uint8_t* sign,
                                  const float* rowscale, const int* rowid,
                                  const int* shift, const int* last,
                                  const int* nnz, int nt, int L, int depth) {
  const int d = depth > 0 ? depth : INT_MAX;
  int cap = kMaxPlanes < L ? kMaxPlanes : L;
  cap = cap < d ? cap : d;
  return {planes, sign,   rowscale, rowid, shift,  last,   nnz,
          nt,     L,      d,        cap,   nullptr, nullptr, nullptr};
}

// v1 and v2: one slot is one group.  prepare copies column j's row tiles
// to shared memory (loaded beside nnz, not after it) and returns G; a list
// past L traps (the call raises).
struct SlotList {
  const int* rowid;
  const int* nnz;
  int L;
  int* srow;     // shared: row tile of slot l

  __host__ __device__ static size_t meta_bytes(int L) {
    return ((size_t)L * 4 + 15) / 16 * 16;
  }
  __device__ int prepare(int j, int* meta) {
    srow = meta;
    for (int l = threadIdx.x; l < L; l += kThreads)
      srow[l] = rowid[(size_t)j * L + l];
    const int n = nnz[j];
    if (n < 0 || n > L) __trap();
    __syncthreads();
    return n;
  }
  __device__ int row_tile(int, int g) const { return srow[g]; }
};

// v1: each slot's tile [128][128] B of uint8 codewords, its sign bitmap
// [16][128] B (rows packed MSB first) and 2^row_exp [128] f32.  Stage: the
// BN-column codeword strip [128][BN] B, the sign strip [16][BN] B, then
// 2^row_exp, all in 16-byte copies.  Decode: thread (r, h) reads its BN / 2
// codes of row r and their sign bytes as 32-bit words, 16 columns per part,
// and writes code * sign * 2^row_exp (both factors exact: any order).
template <int BN>
struct BytecodeStrip : SlotList {
  static constexpr int kBN = BN;
  static constexpr int kWS = BN + 4;
  static constexpr int kPayloadStages = 1;
  static constexpr int kC = BN / 16;             // 16-byte pieces per row
  const uint8_t* codes;
  const uint8_t* sign;
  const float* rowscale;

  __host__ __device__ size_t payload_bytes() const {
    return (size_t)(kTile + 16) * BN + 512;
  }

  __device__ void issue(int j, int col0, int g, uint8_t* st) const {
    const size_t slot = (size_t)j * L + g;
    const uint8_t* src = codes + slot * (kTile * kTile) + col0;
    const uint8_t* sgn = sign + slot * (16 * kTile) + col0;
    // rows 0..127 are codeword rows, 128..143 the packed sign rows
    for (int q = threadIdx.x; q < (kTile + 16) * kC + 32; q += kThreads) {
      if (q < (kTile + 16) * kC) {
        const int r = q / kC, c = q % kC;
        cp_async16(st + r * BN + 16 * c,
                   (r < kTile ? src + r * kTile : sgn + (r - kTile) * kTile) +
                       16 * c);
      } else {
        const int c = q - (kTile + 16) * kC;
        cp_async16(st + (kTile + 16) * BN + 16 * c,
                   rowscale + slot * kTile + 4 * c);
      }
    }
  }

  __device__ void decode(const uint8_t* st, int, float* ws) const {
    const int r = threadIdx.x & 127, h = threadIdx.x >> 7;
    const int bs = 7 - (r & 7);
    const float rs =
        reinterpret_cast<const float*>(st + (kTile + 16) * BN)[r];
#pragma unroll
    for (int part = 0; part < BN / 32; ++part) {
      const int col = h * (BN / 2) + 16 * part;
      const uint4 v = *reinterpret_cast<const uint4*>(st + r * BN + col);
      const uint4 sv = *reinterpret_cast<const uint4*>(
          st + (kTile + (r >> 3)) * BN + col);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      const uint32_t su[4] = {sv.x, sv.y, sv.z, sv.w};
      float out[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float code = (float)((u[q] >> (8 * b)) & 0xffu);
          const float s = ((su[q] >> (8 * b + bs)) & 1u) ? -1.0f : 1.0f;
          out[4 * q + b] = __fmul_rn(__fmul_rn(code, s), rs);
        }
      }
      store16(ws + r * kWS + col, out);
    }
  }
};

// sign | exp(3) | mant(2) -> (e > 0) ? +-(4 + m) * 2^-(e + 2) : +0, times
// 2^row_exp; (4 + m) * 2^-(e + 2) is the float 1.m * 2^-e, built from its
// bits.  The reference's decode (sme_spmm6's body) gives the same value,
// and 2^row_exp is applied with the same one rounding as v1's and v3's.
__device__ __forceinline__ float decode6(uint32_t c, float rs) {
  const uint32_t e = (c >> 2) & 7u;
  const float mag = __uint_as_float(((127u - e) << 23) | ((c & 3u) << 21));
  const float v = e ? ((c >> 5) ? -mag : mag) : 0.0f;
  return __fmul_rn(v, rs);
}

// v2: one slot is one group, its tile [128][96] B of 6-bit codes (4 per 3
// bytes, first code in the low bits) and its 2^row_exp [128] f32.  Stage:
// the BN-column strip [128][BN / 4 * 3] B, then 2^row_exp.  Decode: thread
// (r, h) reads its BN / 2 codes of row r as 32-bit words, 16 codes per 3
// words, and funnel-shifts each out.
template <int BN>
struct Minifloat6Strip : SlotList {
  static constexpr int kBN = BN;
  static constexpr int kWS = BN + 4;
  static constexpr int kPayloadStages = 2;
  static constexpr int kRowB = BN / 4 * 3;
  const uint8_t* packed;
  const float* rowscale;

  __host__ __device__ size_t payload_bytes() const {
    return (size_t)kTile * kRowB + 512;
  }

  __device__ void issue(int j, int col0, int g, uint8_t* st) const {
    const size_t slot = (size_t)j * L + g;
    const uint8_t* src = packed + slot * (kTile * 96) + col0 / 4 * 3;
    constexpr int kChunk = kRowB % 16 == 0 ? 16 : 8;
    constexpr int kPerRow = kRowB / kChunk;
    for (int q = threadIdx.x; q < kTile * kPerRow + 32; q += kThreads) {
      if (q < kTile * kPerRow) {
        const int r = q / kPerRow, c = q % kPerRow;
        if (kChunk == 16)
          cp_async16(st + r * kRowB + 16 * c, src + r * 96 + 16 * c);
        else
          cp_async8(st + r * kRowB + 8 * c, src + r * 96 + 8 * c);
      } else {
        const int c = q - kTile * kPerRow;
        cp_async16(st + kTile * kRowB + 16 * c,
                   rowscale + slot * kTile + 4 * c);
      }
    }
  }

  __device__ void decode(const uint8_t* st, int, float* ws) const {
    const int r = threadIdx.x & 127, h = threadIdx.x >> 7;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        st + r * kRowB + h * (kRowB / 2));
    const float rs = reinterpret_cast<const float*>(st + kTile * kRowB)[r];
#pragma unroll
    for (int part = 0; part < BN / 32; ++part) {
      const uint32_t wd[4] = {src[3 * part], src[3 * part + 1],
                              src[3 * part + 2], 0u};
      float out[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = (6 * i) >> 5, s = (6 * i) & 31;
        out[i] = decode6(__funnelshift_r(wd[q], wd[q + 1], s) & 63u, rs);
      }
      store16(ws + r * kWS + h * (BN / 2) + 16 * part, out);
    }
  }
};

// ---- decode_walk ----------------------------------------------------------

// Launch shape of decode_walk, from the host's view of the operands: the
// groups of a column are at most min(row tiles, list length).  A block
// holds its ring of stages, the decoded strip, one [MB][32] partial per
// group it computes and the decoder's metadata; the partials and the x
// slices grow with the M bucket and with the row tiles per rank, so a
// deep weight (K = 15360: 120 row tiles, 15 per rank) at the M <= 64
// bucket would pass kMaxSmem with v3's 16 staged planes.  Then the bucket
// halves (more, shorter M tiles in grid.y) until the block fits: rows are
// independent, so every output keeps its chains and its list-order sum.
struct DecodeShape {
  int mr, mb, cs, per_rank;
  size_t stage, smem;
  dim3 grid;
};

template <class D>
inline DecodeShape decode_shape(const D& d, int m, int k_pad, int nt, int L) {
  DecodeShape s;
  int gcap = k_pad / kTile < L ? k_pad / kTile : L;
  gcap = gcap < 1 ? 1 : gcap;
  s.cs = 1;
  while (s.cs < kMaxCluster && s.cs < gcap) s.cs *= 2;
  s.per_rank = (gcap + s.cs - 1) / s.cs;
  for (s.mr = m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8;; s.mr /= 2) {
    s.mb = 8 * s.mr;
    s.stage = d.payload_bytes() + (size_t)s.mb * kTile * 4;
    s.smem = (s.per_rank > 1 ? 2 : 1) * s.stage +
             (size_t)kTile * D::kWS * 4 +
             (size_t)s.per_rank * s.mb * kStrip * 4 + D::meta_bytes(L);
    if (s.smem <= (size_t)kMaxSmem || s.mr == 1) break;
  }
  s.grid = dim3(nt * kStrips * s.cs, (m + s.mb - 1) / s.mb);
  return s;
}

// At M <= 8 (the serving decode step) six blocks fit an SM's registers, so
// a 2816-wide layer's 704 blocks run in one wave; larger M keeps four.
template <class D, int MR>
__global__ void __launch_bounds__(kThreads, MR == 1 ? 6 : 4)
decode_walk(D d, const float* __restrict__ x, int m, int k_pad,
            const float* __restrict__ colscale, int nt, int stage_bytes,
            int per_rank, float* __restrict__ y) {
  constexpr int MB = 8 * MR;
  static_assert(D::kBN == kStrip, "decode_walk decodes 32-column strips");
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cl = blockIdx.x / cs;
  const int j = cl / kStrips, col0 = (cl % kStrips) * kStrip;
  const int m0 = blockIdx.y * MB;
  // one stage when each rank has one group, else a ring of two
  float* ws = reinterpret_cast<float*>(
      smem + (per_rank > 1 ? 2 : 1) * stage_bytes);
  float* part = ws + kTile * D::kWS;                 // [per_rank][MB][32]
  int* meta = reinterpret_cast<int*>(part + per_rank * MB * kStrip);
  const int xoff = (int)d.payload_bytes();

  // the host sized the partials for one group per row tile, as the
  // packer's lists hold; a list with more groups traps (the call raises)
  // rather than drop some
  const int G = d.prepare(j, meta);
  if (G > per_rank * cs) __trap();
  const int mine = rank < G ? (G - rank + cs - 1) / cs : 0;
  auto issue = [&](int i) {
    if (i < mine) {
      const int g = rank + i * cs;
      uint8_t* st = smem + (i & 1) * stage_bytes;
      d.issue(j, col0, g, st);
      issue_x<false>(reinterpret_cast<float*>(st + xoff), x, m, m0, MB, k_pad,
                     d.row_tile(j, g));
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem + (i & 1) * stage_bytes;
    d.decode(st, rank + i * cs, ws);
    __syncthreads();
    const float4* xs = reinterpret_cast<const float4*>(st + xoff);
    float t[MR];
#pragma unroll
    for (int a = 0; a < MR; ++a) t[a] = 0.0f;
#pragma unroll 2
    for (int k4 = 0; k4 < kTile / 4; ++k4) {
      float4 xv[MR];
#pragma unroll
      for (int a = 0; a < MR; ++a) xv[a] = xs[(w + kWarps * a) * 32 + k4];
      const float* wk = ws + 4 * k4 * D::kWS + lane;
      const float w0 = wk[0], w1 = wk[D::kWS], w2 = wk[2 * D::kWS],
                  w3 = wk[3 * D::kWS];
#pragma unroll
      for (int a = 0; a < MR; ++a) {
        t[a] = fmaf(xv[a].x, w0, t[a]);
        t[a] = fmaf(xv[a].y, w1, t[a]);
        t[a] = fmaf(xv[a].z, w2, t[a]);
        t[a] = fmaf(xv[a].w, w3, t[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < MR; ++a)
      part[(i * MB + w + kWarps * a) * kStrip + lane] = t[a];
    __syncthreads();
    issue(i + 2);
  }
  cp_async_wait<0>();
  cluster.sync();

  // each rank adds a share of the outputs' partials, in list order
  for (int o = threadIdx.x + rank * kThreads; o < MB * kStrip;
       o += kThreads * cs) {
    const int row = o / kStrip, c = o % kStrip;
    float acc = 0.0f;
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const float* p = cluster.map_shared_rank(part, g % cs);
      acc = __fadd_rn(acc, p[((g / cs) * MB + row) * kStrip + c]);
    }
    if (m0 + row < m) {
      const int col = j * kTile + col0 + c;
      y[(size_t)(m0 + row) * nt * kTile + col] =
          colscale ? __fmul_rn(acc, colscale[col]) : acc;
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// Raise a kernel's dynamic shared memory limit, once per device: `allowed`
// is the caller's per-kernel record of what each device allows already.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)kMaxSmem || dev >= 64) return cudaErrorInvalidValue;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <class D, int MR>
inline cudaError_t launch_decode_mr(const D& d, const DecodeShape& s,
                                    const float* x, int m, int k_pad,
                                    const float* colscale, int nt, float* y,
                                    cudaStream_t stream) {
  static size_t allowed[64] = {};
  auto kernel = decode_walk<D, MR>;
  cudaError_t err = allow_smem(kernel, s.smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = s.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, d, x, m, k_pad, colscale, nt,
                           (int)s.stage, s.per_rank, y);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class D>
inline cudaError_t launch_decode(const D& d, int m, int k_pad, int nt, int L,
                                 const float* x, const float* colscale,
                                 float* y, cudaStream_t stream) {
  const DecodeShape s = decode_shape(d, m, k_pad, nt, L);
  switch (s.mr) {
    case 1:
      return launch_decode_mr<D, 1>(d, s, x, m, k_pad, colscale, nt, y,
                                    stream);
    case 2:
      return launch_decode_mr<D, 2>(d, s, x, m, k_pad, colscale, nt, y,
                                    stream);
    case 4:
      return launch_decode_mr<D, 4>(d, s, x, m, k_pad, colscale, nt, y,
                                    stream);
    default:
      return launch_decode_mr<D, 8>(d, s, x, m, k_pad, colscale, nt, y,
                                    stream);
  }
}

// ---- tiled_walk -----------------------------------------------------------

constexpr int kXBytes = kBM * kTile * 4;   // one stage's x slice

template <class D>
inline size_t tiled_stage_bytes(const D& d) {
  return d.payload_bytes() + (size_t)kXBytes;
}

template <class D>
inline size_t tiled_smem_bytes(const D& d) {
  return D::kPayloadStages * d.payload_bytes() + 2 * (size_t)kXBytes +
         (size_t)kTile * D::kWS * 4 + D::meta_bytes(d.L);
}

// Shared memory: kPayloadStages == 2: [payload 0 | x 0][payload 1 | x 1];
// == 1: [payload][x 0][x 1]; then the strip ws and the decoder's metadata.
template <class D>
__global__ void __launch_bounds__(kThreads, 2)
tiled_walk(D d, const float* __restrict__ x, int m, int k_pad, int nt,
           int stage_bytes, float* __restrict__ y) {
  static_assert(D::kBN == kBN, "tiled_walk decodes 64-column halves");
  constexpr int P = D::kPayloadStages;
  static_assert(P == 1 || P == 2, "one payload buffer or a ring of two");
  extern __shared__ __align__(16) uint8_t smem[];
  const int j = blockIdx.x / (kTile / kBN);
  const int col0 = (blockIdx.x % (kTile / kBN)) * kBN;
  const int m0 = blockIdx.y * kBM;
  const int xoff = (int)d.payload_bytes();
  float* ws = reinterpret_cast<float*>(
      smem + (P == 2 ? 2 * stage_bytes : xoff + 2 * kXBytes));
  const int xstep = P == 2 ? stage_bytes : kXBytes;
  const int G = d.prepare(j, reinterpret_cast<int*>(ws + kTile * D::kWS));
  // x of group g (and with P == 2 its payload) into stage g & 1
  auto issue = [&](int g) {
    if (g < G) {
      if (P == 2) d.issue(j, col0, g, smem + (g & 1) * stage_bytes);
      issue_x<true>(reinterpret_cast<float*>(smem + xoff + (g & 1) * xstep),
                    x, m, m0, kBM, k_pad, d.row_tile(j, g));
    }
    cp_async_commit();
  };
  if (P == 1 && G > 0) d.issue(j, col0, 0, smem);
  issue(0);
  issue(1);

  // thread (tm, tn): rows 4tm..4tm+3, columns 4tn..4tn+3 of the block
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int sw = tm & 7;   // issue_x's swizzle of rows 4tm..4tm+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem + (P == 2 ? (g & 1) * stage_bytes : 0);
    d.decode(st, g, ws);
    __syncthreads();
    if (P == 1) {   // the one payload buffer is free: group g + 1's lands
      if (g + 1 < G) d.issue(j, col0, g + 1, smem);   // during this dot
      cp_async_commit();
    }
    const float* xs = reinterpret_cast<const float*>(
                          smem + xoff + (g & 1) * xstep) +
                      4 * tm * kTile;
    const float* wn = ws + 4 * tn;
    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[i][c] = 0.0f;
#pragma unroll 2
    for (int k4 = 0; k4 < kTile / 4; ++k4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + i * kTile +
                                                 4 * (k4 ^ sw));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wn + (4 * k4 + kk) * D::kWS);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xk = kk == 0 ? xv[i].x
                           : kk == 1 ? xv[i].y
                           : kk == 2 ? xv[i].z
                                     : xv[i].w;
          t[i][0] = fmaf(xk, wv.x, t[i][0]);
          t[i][1] = fmaf(xk, wv.y, t[i][1]);
          t[i][2] = fmaf(xk, wv.z, t[i][2]);
          t[i][3] = fmaf(xk, wv.w, t[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = __fadd_rn(acc[i][c], t[i][c]);
    __syncthreads();
    issue(g + 2);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * tm + i;
    if (row < m)
      *reinterpret_cast<float4*>(y + (size_t)row * nt * kTile + j * kTile +
                                 col0 + 4 * tn) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

inline dim3 tiled_grid(int m, int nt) {
  return dim3(nt * (kTile / kBN), (m + kBM - 1) / kBM);
}

template <class D>
inline cudaError_t launch_tiled(const D& d, int m, int k_pad, int nt,
                                const float* x, float* y,
                                cudaStream_t stream) {
  static size_t allowed[64] = {};
  auto kernel = tiled_walk<D>;
  const size_t smem = tiled_smem_bytes(d);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<tiled_grid(m, nt), kThreads, smem, stream>>>(
      d, x, m, k_pad, nt, (int)tiled_stage_bytes(d), y);
  return cudaGetLastError();
}

// ---- entry points ---------------------------------------------------------

// v1 and v2 serve every M from one entry point: decode_walk with the
// 32-column strip where 2M <= 128, tiled_walk with the 64-column one above.
inline bool decode_sized(int m) { return 2 * m <= kTile; }

template <class D32, class D64>
inline cudaError_t launch_by_m(const D32& d32, const D64& d64, int m,
                               int k_pad, int nt, int L, const float* x,
                               float* y, cudaStream_t stream) {
  if (decode_sized(m))
    return launch_decode(d32, m, k_pad, nt, L, x, nullptr, y, stream);
  return launch_tiled(d64, m, k_pad, nt, x, y, stream);
}

// Launch shape, as the `<kernel>_geometry` exports report it: out = {grid
// x, grid y, cluster size, dynamic shared memory bytes}.  Returns
// cudaErrorInvalidValue where a block cannot hold that much shared memory
// (the launch would refuse it), else 0.
inline int report_geometry(dim3 grid, int cs, size_t smem, int* out) {
  out[0] = (int)grid.x;
  out[1] = (int)grid.y;
  out[2] = cs;
  out[3] = (int)smem;
  return smem > (size_t)kMaxSmem ? (int)cudaErrorInvalidValue : 0;
}

template <class D>
inline int decode_geometry(const D& d, int m, int k_pad, int nt, int L,
                           int* out) {
  const DecodeShape s = decode_shape(d, m, k_pad, nt, L);
  return report_geometry(s.grid, s.cs, s.smem, out);
}

template <class D>
inline int tiled_geometry(const D& d, int m, int nt, int* out) {
  return report_geometry(tiled_grid(m, nt), 1, tiled_smem_bytes(d), out);
}

template <class D32, class D64>
inline int geometry_by_m(const D32& d32, const D64& d64, int m, int k_pad,
                         int nt, int L, int* out) {
  return decode_sized(m) ? decode_geometry(d32, m, k_pad, nt, L, out)
                         : tiled_geometry(d64, m, nt, out);
}

}  // namespace ordered_partials
