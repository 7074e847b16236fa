// Fused packed dequant + matmul of the weight-only quantized serve path,
// K12: out (M, N) fp32 = x (M, K) @ w (K, N), with w stored as int2/3/4
// codes and w = code * scale + min dequantized on the fly.
//
// Replaces src/repro/kernels/wq_kernel.py::matmul_pallas (the Pallas kernel
// behind every w* matmul site of the block stacks under repro.wq).
//
// Bound on the H100: at decode (M = 4) bytes, the packed weights and their
// fp16 scales / mins, bits/16 + 2/group of the bf16 weight's bytes; at
// prefill (M up to 4 096) the bf16 operations.  Design, simple first: one
// block of four warps per (64-row M tile, 64-column N tile), with the K
// sweep inside the block (Hopper runs blocks in no order, so the TPU
// kernel's sequential K grid axis and its VMEM accumulator become a loop
// and registers).  Each K step dequantizes a (64, 64) weight tile into
// shared memory: one thread takes one 8-code octet o of one column, the
// bytes words[o * bits + b, col] (b < bits) read as one little-endian word,
// so neighbouring threads read neighbouring columns.  An octet lies in one
// scale group (group is a multiple of 8).  code * scale + min is formed in
// fp32 with __fmul_rn / __fadd_rn (no FMA contraction: the plain version
// rounds both operations), then rounded to the activation dtype.  bf16
// activations contract on the tensor cores with mma.sync m16n8k16 and fp32
// accumulators (the instruction K1 uses); fp32 activations with an FFMA
// loop, no TF32.  Ragged edges are masked, not padded: missing bytes of a
// short last octet read as 0, rows past K dequantize to 0 and read x as 0,
// rows past M and columns past N are neither read nor written.  A warp
// whose 16 rows all lie past M skips its products (decode: 3 of 4 warps).
// Not yet: a GEMV variant for small M, split-K, wgmma, TMA.
#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_16816;

constexpr int kBM = 64, kBN = 64, kBK = 64, kThreads = 128;
constexpr int kLd = kBK + 8;  // bf16 smem row stride: conflict-free frags

struct Packed {
  const uint8_t* words;  // (PK, N) uint8
  const __half* scales;  // (G, N) fp16
  const __half* mins;    // (G, N) fp16
  int K, N, PK, bits, group;
};

// The 8 weights of octet `o` (rows 8 o .. 8 o + 7) of column `col` in fp32,
// 0 past K or N.
__device__ __forceinline__ void dequant_octet(const Packed& p, int o,
                                              int col, float w[8]) {
  const int k = o * 8;
  if (col >= p.N || k >= p.K) {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = 0.0f;
    return;
  }
  uint32_t word = 0u;
  for (int b = 0; b < p.bits; ++b) {
    const int r = o * p.bits + b;
    if (r < p.PK) word |= (uint32_t)p.words[(long long)r * p.N + col]
                          << (8 * b);
  }
  const long long gi = (long long)(k / p.group) * p.N + col;
  const float s = __half2float(p.scales[gi]), m = __half2float(p.mins[gi]);
  const uint32_t mask = (1u << p.bits) - 1u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float code = (float)((word >> (j * p.bits)) & mask);
    w[j] = k + j < p.K ? __fadd_rn(__fmul_rn(code, s), m) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    wq_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, Packed p,
                          float* __restrict__ out, int M) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kBM * kLd];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 w_s[kBN * kLd];  // [n][k]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int K = p.K, N = p.N;
  const bool live = m0 + warp * 16 < M;  // uniform across the warp
  const bool vec = K % 8 == 0 && ((uintptr_t)x & 15u) == 0u;

  float acc[kBN / 8][4];
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's smem reads are done
    // x tile: 8 columns a thread, zero past M and K
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c8 = (i % (kBK / 8)) * 8;
      const int row = m0 + r, k = k0 + c8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        const __nv_bfloat16* src = x + (long long)row * K + k;
        if (vec && k + 8 <= K) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) __nv_bfloat16 e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = k + j < K ? src[j] : __float2bfloat16_rn(0.0f);
          val = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(x_s + r * kLd + c8) = val;
    }
    // weight tile, n-major: the B operand reads two consecutive k at once
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int c = i % kBN, o = i / kBN;
      float w[8];
      dequant_octet(p, k0 / 8 + o, n0 + c, w);
      uint4 val;
      val.x = flash::pack_bf16(w[0], w[1]);
      val.y = flash::pack_bf16(w[2], w[3]);
      val.z = flash::pack_bf16(w[4], w[5]);
      val.w = flash::pack_bf16(w[6], w[7]);
      *reinterpret_cast<uint4*>(w_s + c * kLd + o * 8) = val;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const __nv_bfloat16* xa = x_s + kk * 16 + t * 2;
      uint32_t a[4];
      a[0] = ld32(xa + (warp * 16 + g) * kLd);
      a[1] = ld32(xa + (warp * 16 + g + 8) * kLd);
      a[2] = ld32(xa + (warp * 16 + g) * kLd + 8);
      a[3] = ld32(xa + (warp * 16 + g + 8) * kLd + 8);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const __nv_bfloat16* wb = w_s + (n * 8 + g) * kLd + kk * 16 + t * 2;
        mma_16816(acc[n], a, ld32(wb), ld32(wb + 8));
      }
    }
  }

  if (!live) return;
  const int row0 = m0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1, col = n0 + n * 8 + t * 2 + (e & 1);
      if (row < M && col < N) out[(long long)row * N + col] = acc[n][e];
    }
  }
}

// fp32 activations: each thread owns 4 rows x 8 columns (columns tx + 8 j)
__global__ void __launch_bounds__(kThreads)
    wq_matmul_f32_kernel(const float* __restrict__ x, Packed p,
                         float* __restrict__ out, int M) {
  __shared__ float x_s[kBM][kBK + 1];
  __shared__ float w_s[kBK][kBN];  // [k][n]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int K = p.K, N = p.N;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int row = m0 + r, k = k0 + c;
      x_s[r][c] = row < M && k < K ? x[(long long)row * K + k] : 0.0f;
    }
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int c = i % kBN, o = i / kBN;
      float w[8];
      dequant_octet(p, k0 / 8 + o, n0 + c, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) w_s[o * 8 + j][c] = w[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_s[ty * 4 + i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = w_s[k][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 8 * j;
      if (row < M && col < N) out[(long long)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// x (M, K) bf16 or fp32 contiguous; words (PK = ceil(K bits / 8), N)
// uint8, scales / mins (ceil(K / group), N) fp16, all contiguous; out (M, N)
// fp32 contiguous.  bits in 2..4, group a positive multiple of 8, M at most
// 65 535 * 64.  Returns cudaGetLastError().
extern "C" int wq_matmul_bf16(const void* x, const void* words,
                              const void* scales, const void* mins,
                              void* out, int M, int K, int N, int bits,
                              int group, void* stream) {
  const Packed p{static_cast<const uint8_t*>(words),
                 static_cast<const __half*>(scales),
                 static_cast<const __half*>(mins), K, N,
                 (K * bits + 7) / 8, bits, group};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  wq_matmul_bf16_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), p, static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}

extern "C" int wq_matmul_f32(const void* x, const void* words,
                             const void* scales, const void* mins, void* out,
                             int M, int K, int N, int bits, int group,
                             void* stream) {
  const Packed p{static_cast<const uint8_t*>(words),
                 static_cast<const __half*>(scales),
                 static_cast<const __half*>(mins), K, N,
                 (K * bits + 7) / 8, bits, group};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  wq_matmul_f32_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), p, static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}
