// Position masks, TMA tensor maps of (B, S, H, D) views and fragment
// helpers shared by the flash-attention kernels K1 (flash_fwd.cu) and
// K2 / K3 (flash_bwd.cu); K12 (wq.cu) uses the mma.sync product and ld32.
//
// Widths that are not a multiple of 32 (zamba2_2_7b's 80): a tile of W
// columns with W % 64 = 16 is laid out as the tile of W + 16 columns, the
// 64-column blocks of 128-byte swizzle and a 32-column tail block of
// 64-byte swizzle, and its tail box still asks TMA for 32 columns; the
// tensor map's inner extent stays W, so TMA fills the 16 columns past it
// with zeros and still counts them in the barrier's transaction bytes.
// The products that contract over W step only the W / 16 k-steps that
// hold data (the tail block's first); those whose output has W columns run
// the tail's m64n32 product, whose last 16 columns are zero and are never
// stored.  This is the 96-column tile (MLA's (96, 64), proven on the card)
// over an 80-column operand: it reuses the 64-byte swizzle mode and the
// m64n32 product already in use instead of adding a 32-byte mode and an
// m64n16 product the card has not run, at the price of 16 idle output
// columns in the tail's product (a sixth more tensor work in P V, dQ, dK
// and dV at W 80, none in Q K^T and dO V^T).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kFar = 1 << 30;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8) += A(16x16, row-major) * B(16x8, col-major); bf16 in, fp32 acc.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of one k-step (16 columns) taken straight from two fp32
// accumulator n-tiles (columns 16 kk .. 16 kk + 15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ bool visible_pos(long long qp, long long kp,
                                            int has_window, int window) {
  return kp <= qp && (!has_window || qp - kp < window);
}

// The reference's _visible: can any row of a q tile see any key of a kv
// tile, judged from their position extrema?
__device__ __forceinline__ bool tiles_visible(long long qmin, long long qmax,
                                              long long kmin, long long kmax,
                                              int has_window, int window) {
  return kmin <= qmax && (!has_window || kmax > qmin - window);
}

// Does every row of a q tile see every key of a kv tile?
__device__ __forceinline__ bool tiles_all_visible(long long qmin,
                                                  long long qmax,
                                                  long long kmin,
                                                  long long kmax,
                                                  int has_window,
                                                  int window) {
  return kmax <= qmin && (!has_window || qmax - kmin < window);
}

// Extrema of pos[i0 .. i0 + 64) below n over one warp; every lane gets
// them, (kFar, -kFar) for an empty range.
__device__ __forceinline__ void warp_extrema(const int* __restrict__ pos,
                                             int i0, int n, int lane,
                                             int& lo, int& hi) {
  lo = kFar;
  hi = -kFar;
  for (int j = lane; j < 64; j += 32) {
    if (i0 + j < n) {
      const int p = pos[i0 + j];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Which of dims 1..3 of a tensor map holds the sequence, head and batch
// axis (two bits each).
struct Axes {
  int s, h, b;
};

__device__ __forceinline__ Axes unpack_axes(int code) {
  return Axes{code & 3, (code >> 2) & 3, (code >> 4) & 3};
}

// A tile of W columns (W = 64 n + r, r 0, 16 or 32) of `rows` rows in
// shared memory: n column blocks of one 128-byte swizzle atom (64 columns,
// rows x 128 B each), then for r > 0 one tail block of 32 columns with a
// 64-byte swizzle atom (rows x 64 B), of which r hold data (the rest TMA's
// zeros).  Every block starts 1 024-aligned when the tile does and rows is
// a multiple of 8.
template <int W>
struct Cols {
  static_assert(W % 16 == 0 && W % 64 <= 32 && W >= 64,
                "a tile is 64-column blocks and at most one 32-column tail");
  static constexpr int kFull = W / 64;        // 128-byte blocks
  static constexpr bool kTail = W % 64 != 0;  // then one 64-byte block
  static constexpr int kPad = (W + 31) / 32 * 32;  // columns kept
  static constexpr int kSteps = W / 16;  // k-steps of 16 columns with data
};

// TMA load of `rows` positions of one head of one batch row at (row0,
// head, batch) into a W-column tile at dst: box j of `map` (64 columns,
// 128-byte swizzle) for each full block, one box of `tail` (32 columns,
// 64-byte swizzle) for the tail block.
template <int W>
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, Axes ax, int row0,
                                          int head, int batch, int rows) {
  int c[4] = {0, 0, 0, 0};
  c[ax.s] = row0;
  c[ax.h] = head;
  c[ax.b] = batch;
  uint8_t* d = static_cast<uint8_t*>(dst);
#pragma unroll
  for (int j = 0; j < Cols<W>::kFull; ++j)
    hopper::tma_load_4d(d + j * rows * 128, map, bar, 64 * j, c[1], c[2],
                        c[3]);
  if (Cols<W>::kTail)
    hopper::tma_load_4d(d + Cols<W>::kFull * rows * 128, tail, bar,
                        64 * Cols<W>::kFull, c[1], c[2], c[3]);
}

// Descriptor of k-step kk (columns 16 kk ..) of rows r0 .. r0 + 63 of a
// W-column tile of `rows` rows read K-major (A, or B as [n][k]): +32 B a
// step within a block's atom, then the next block.
template <int W>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int rows,
                                                int r0, int kk) {
  constexpr int kFull = Cols<W>::kFull;
  const uint8_t* t = static_cast<const uint8_t*>(tile);
  if (kk < 4 * kFull)
    return hopper::desc_sw128(t + (kk >> 2) * rows * 128 + r0 * 128) +
           (uint64_t)(2 * (kk & 3));
  return hopper::desc_sw64(t + kFull * rows * 128 + r0 * 64) +
         (uint64_t)(2 * (kk - 4 * kFull));
}

// acc (+)= A B with B a W-column tile of `rows` rows read MN-major (its
// rows the contraction) and A the register fragments of KS k-steps; acc
// holds the Cols<W>::kPad / 2 accumulators of a row of 64 (column
// 8 j + 2 t + e in element 4 j + e): one m64n64 product per full block,
// one m64n32 for the tail (at W 80 its last 16 columns are TMA's zeros).
template <int W, int KS>
__device__ __forceinline__ void mma_mn(float (&acc)[Cols<W>::kPad / 2],
                                       const uint32_t (&a)[KS][4],
                                       const void* tile, int rows) {
  constexpr int kFull = Cols<W>::kFull;
  const uint8_t* t = static_cast<const uint8_t*>(tile);
#pragma unroll
  for (int c = 0; c < kFull; ++c) {
    const uint64_t d = hopper::desc_sw128(t + c * rows * 128);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_m64n64_rs<1>(
          *reinterpret_cast<float(*)[32]>(&acc[32 * c]), a[kk],
          d + (uint64_t)(128 * kk), 1);
  }
  if constexpr (Cols<W>::kTail) {
    const uint64_t d = hopper::desc_sw64(t + kFull * rows * 128);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_m64n32_rs<1>(
          *reinterpret_cast<float(*)[16]>(&acc[32 * kFull]), a[kk],
          d + (uint64_t)(64 * kk), 1);
  }
}

// A narrow tile: W columns kept as W / 32 blocks of 32 columns, each of
// one 64-byte swizzle atom (rows x 64 B, block j at j rows 64 B), so that a
// product can read any 32 of its columns MN-major.  K3 keeps Q so at
// (192, 128), where each warpgroup owns 96 of dK's columns.  TMA loads box
// j of `map` (32 columns, 64-byte swizzle) into block j.
template <int W>
__device__ __forceinline__ void load_narrow(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, Axes ax, int row0,
                                            int head, int batch, int rows) {
  static_assert(W % 32 == 0, "a narrow tile is 32-column blocks");
  int c[4] = {0, 0, 0, 0};
  c[ax.s] = row0;
  c[ax.h] = head;
  c[ax.b] = batch;
  uint8_t* d = static_cast<uint8_t*>(dst);
#pragma unroll
  for (int j = 0; j < W / 32; ++j)
    hopper::tma_load_4d(d + j * rows * 64, map, bar, 32 * j, c[1], c[2],
                        c[3]);
}

// Descriptor of k-step kk (columns 16 kk ..) of rows r0 .. r0 + 63 of a
// narrow tile read K-major: +32 B a step within a block, then the next.
__device__ __forceinline__ uint64_t narrow_kdesc(const void* tile, int rows,
                                                 int r0, int kk) {
  const uint8_t* t = static_cast<const uint8_t*>(tile);
  return hopper::desc_sw64(t + (kk >> 1) * rows * 64 + r0 * 64) +
         (uint64_t)(2 * (kk & 1));
}

// acc (+)= A B with B the N columns of blocks c0 .. c0 + N / 32 - 1 of a
// narrow tile of `rows` rows read MN-major (its rows the contraction), A
// the register fragments of KS k-steps: one m64n32 product a block; acc
// holds column 8 j + 2 t + e of the N in element 4 j + e, as mma_mn's.
template <int N, int KS>
__device__ __forceinline__ void mma_narrow(float (&acc)[N / 2],
                                           const uint32_t (&a)[KS][4],
                                           const void* tile, int rows,
                                           int c0) {
  const uint8_t* t = static_cast<const uint8_t*>(tile);
#pragma unroll
  for (int c = 0; c < N / 32; ++c) {
    const uint64_t d = hopper::desc_sw64(t + (c0 + c) * rows * 64);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::wgmma_m64n32_rs<1>(
          *reinterpret_cast<float(*)[16]>(&acc[16 * c]), a[kk],
          d + (uint64_t)(64 * kk), 1);
  }
}

// A 4-D tensor map of a (B, S, heads, hd) bf16 view given by element
// strides: dim 0 is the contiguous head axis, dims 1..3 the sequence, head
// and batch axes in increasing stride order.  Box: `rows` positions of one
// head of one batch row and `cols` columns, 64 with 128-byte swizzle (a
// full block of load_rows) or 32 with 64-byte swizzle (its tail; at hd 80
// the box runs 16 columns past the tensor, which TMA fills with zeros).
// Returns the Axes code, or -1 (also for a width Cols does not take).
inline int map_bshd(CUtensorMap* map, const void* base, int hd, int S,
                    int heads, int B, long long ss, long long sh,
                    long long sb, int rows, int cols = 64) {
  struct Ax {
    uint64_t n, stride;
    uint32_t box;
    int which;
  } ax[3] = {{(uint64_t)S, 2ull * ss, (uint32_t)rows, 0},
             {(uint64_t)heads, 2ull * sh, 1u, 1},
             {(uint64_t)B, 2ull * sb, 1u, 2}};
  for (int i = 1; i < 3; ++i)  // stable insertion sort by stride
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      const Ax t = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = t;
    }
  const uint64_t dims[4] = {(uint64_t)hd, ax[0].n, ax[1].n, ax[2].n};
  const uint64_t strides[3] = {ax[0].stride, ax[1].stride, ax[2].stride};
  if (hd < 64 || hd % 16 || hd % 64 > 32 || (cols != 64 && cols != 32))
    return -1;
  const uint32_t box[4] = {(uint32_t)cols, ax[0].box, ax[1].box, ax[2].box};
  if (!hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                        strides, box,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B))
    return -1;
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[ax[i].which] = i + 1;
  return pos[0] | (pos[1] << 2) | (pos[2] << 4);
}

// The maps of one operand of width hd: `main` (64-column boxes) and, for a
// width with a tail (16 or 32 columns), `tail`, of 32-column boxes; a copy
// of `main` (never read) otherwise.  Returns the Axes code, or -1.
inline int map_operand(CUtensorMap* main, CUtensorMap* tail,
                       const void* base, int hd, int S, int heads, int B,
                       long long ss, long long sh, long long sb, int rows) {
  const int ax = map_bshd(main, base, hd, S, heads, B, ss, sh, sb, rows);
  if (ax < 0) return -1;
  if (hd % 64 == 0) {
    *tail = *main;
    return ax;
  }
  return map_bshd(tail, base, hd, S, heads, B, ss, sh, sb, rows, 32) == ax
             ? ax
             : -1;
}

}  // namespace flash
