// Position masks, TMA tensor maps of (B, S, H, D) views and fragment
// helpers shared by the flash-attention kernels K1 (flash_fwd.cu) and
// K2 / K3 (flash_bwd.cu); K12 (wq.cu) uses the mma.sync product and ld32.
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

// TMA load of `rows` positions of one head of one batch row at (row0,
// head, batch): HD / 64 boxes of one 128-byte swizzle atom (64 columns)
// each, box j (columns 64 j ..) to dst + j rows 128 B.  A tile is so HD / 64
// column blocks of `rows` 128-byte rows; a wgmma operand steps along them
// with kmajor_step, or takes one block per 64 output columns.
template <int HD>
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, Axes ax, int row0,
                                          int head, int batch, int rows) {
  int c[4] = {0, 0, 0, 0};
  c[ax.s] = row0;
  c[ax.h] = head;
  c[ax.b] = batch;
#pragma unroll
  for (int j = 0; j < HD / 64; ++j)
    hopper::tma_load_4d(static_cast<uint8_t*>(dst) + j * rows * 128, map,
                        bar, 64 * j, c[1], c[2], c[3]);
}

// Descriptor offset (16-byte units) of k-step kk (16 columns) of a K-major
// operand whose tile load_rows wrote with `rows` rows: +32 B within a
// 64-column atom, then the next column block, rows x 128 B on.
__device__ __forceinline__ uint64_t kmajor_step(int kk, int rows) {
  return (uint64_t)((kk >> 2) * rows * 8 + 2 * (kk & 3));
}

// Descriptor offset (16-byte units) of column block c of a tile of `rows`
// rows: the MN-major operand of the 64 output columns 64 c ..
__device__ __forceinline__ uint64_t column_block(int c, int rows) {
  return (uint64_t)(c * rows * 8);
}

// The 32 accumulators of output columns 64 c .. 64 c + 63 (one m64n64
// product) of a row-of-64 accumulator array of HD / 2 floats.
template <int R>
__device__ __forceinline__ float (&acc64(float (&a)[R], int c))[32] {
  return *reinterpret_cast<float(*)[32]>(&a[32 * c]);
}

// A 4-D tensor map of a (B, S, heads, hd) bf16 view given by element
// strides: dim 0 is the contiguous head axis, dims 1..3 the sequence, head
// and batch axes in increasing stride order, 128-byte swizzle.  Box:
// `rows` positions of one head of one batch row, 64 columns (the swizzle
// atom; load_rows takes hd / 64 boxes).  Returns the Axes code, or -1 (also
// for hd not a multiple of 64).
inline int map_bshd(CUtensorMap* map, const void* base, int hd, int S,
                    int heads, int B, long long ss, long long sh,
                    long long sb, int rows) {
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
  if (hd <= 0 || hd % 64) return -1;
  const uint32_t box[4] = {64u, ax[0].box, ax[1].box, ax[2].box};
  if (!hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return -1;
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[ax[i].which] = i + 1;
  return pos[0] | (pos[1] << 2) | (pos[2] << 4);
}

}  // namespace flash
