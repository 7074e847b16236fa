// Tile geometry and mma.sync helpers shared by the flash-attention kernels
// K1 (flash_fwd.cu) and K2 / K3 (flash_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int D = 64;         // head dim of q/k and of v
constexpr int kBQ = 64;       // query rows per tile: 4 warps x 16
constexpr int kBKV = 64;      // keys per kv tile
constexpr int kLds = D + 8;   // smem row stride (bf16): conflict-free frags
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr int kFar = 1 << 30;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// A fragments of rows [r0, r0 + 16) of a (64, D) smem tile, for the
// m16n8k16 product over the D axis (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void load_a_frags(uint32_t a[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = tile + kk * 16 + t * 2;
    a[kk][0] = ld32(base + (r0 + g) * kLds);
    a[kk][1] = ld32(base + (r0 + g + 8) * kLds);
    a[kk][2] = ld32(base + (r0 + g) * kLds + 8);
    a[kk][3] = ld32(base + (r0 + g + 8) * kLds + 8);
  }
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

// Extrema of the first n (<= 64) positions of a smem tile.  Every thread
// computes the same values, so a branch on them is uniform.
__device__ __forceinline__ void extrema(const int* pos, int n, long long& lo,
                                        long long& hi) {
  lo = kFar;
  hi = -kFar;
  for (int i = 0; i < n; ++i) {
    lo = min(lo, (long long)pos[i]);
    hi = max(hi, (long long)pos[i]);
  }
}

// Copies rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row stride
// `ld` (elements) into smem; rows at or past `n_rows` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows,
                                          int tid) {
  for (int i = tid; i < 64 * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld +
                                            c8);
    *reinterpret_cast<uint4*>(dst + r * kLds + c8) = val;
  }
}

}  // namespace flash
