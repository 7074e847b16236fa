// RD-FSQ wire kernels K4 (quantize + pack) and K5 (unpack + dequantize).
//
// Replaces src/repro/kernels/rdfsq_kernel.py::quantize_pallas (K4) and
// ::dequantize_pallas (K5), the Pallas kernels behind the 2-bit split wire.
//
// Bound on the H100: bytes.  K4 reads each activation once (2 B in bf16)
// and writes bits/8 B of codes; K5 reads the codes and writes 2 B.  There
// is no reuse, so the only lever is to touch each byte once.  Design: one
// thread per packed output byte, a 2-D grid (words of a row, rows), the
// per-row (lo, hi) read from the stats pass that runs outside the kernel
// (as in the reference).  The kernel reads bf16 directly instead of the
// fp32 copy the reference makes (the cast is exact), and reads the ragged
// last tile of a row as zeros, which is what the reference's zero-padded
// columns hold, so no padded copy is made.
//
// Numerics follow the plain PyTorch version operation by operation:
// every step is an explicitly rounded intrinsic so that nvcc cannot fuse a
// multiply and an add into an FMA, and the round is rintf (half to even, as
// torch.round and jnp.round), never roundf (half away from zero).  The
// codes are then bit-identical to the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^bits levels are always even: the grid is round(half*e - 0.5) + 0.5,
// clipped to +-half (rdfsq_kernel.py:44-48).
template <typename T, int SB>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    uint8_t* __restrict__ words, int64_t C, int64_t CW,
                    float half) {
  constexpr int PER = 8 / SB;
  const int64_t row = blockIdx.y;
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= CW) return;
  const float lo = stats[2 * row], hi = stats[2 * row + 1];
  const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-6f);
  const T* xr = x + row * C;
  unsigned int word = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t col = w * PER + i;
    const float v = col < C ? load_f32(xr + col) : 0.0f;
    const float xc = fminf(fmaxf(v, lo), hi);
    const float e =
        __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, __fsub_rn(xc, lo)), den), 1.0f);
    float z = __fadd_rn(rintf(__fsub_rn(__fmul_rn(half, e), 0.5f)), 0.5f);
    z = fminf(fmaxf(z, -half), half);
    word |= (unsigned int)__fadd_rn(z, half) << (i * SB);
  }
  words[row * CW + w] = (uint8_t)word;
}

template <typename T, int SB>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const uint8_t* __restrict__ words,
                      const float* __restrict__ stats, T* __restrict__ out,
                      int64_t C, int64_t CW, float half) {
  constexpr int PER = 8 / SB;
  constexpr unsigned int MASK = (1u << SB) - 1u;
  const int64_t row = blockIdx.y;
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= CW) return;
  const float lo = stats[2 * row], hi = stats[2 * row + 1];
  const float span = __fsub_rn(hi, lo);
  const unsigned int word = words[row * CW + w];
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t col = w * PER + i;
    if (col >= C) break;
    const float code = (float)((word >> (i * SB)) & MASK);
    const float c = __fdiv_rn(__fsub_rn(code, half), half);
    const float val =
        __fadd_rn(__fmul_rn(__fdiv_rn(__fadd_rn(c, 1.0f), 2.0f), span), lo);
    store_f32(orow + col, val);
  }
}

template <typename T, int SB>
void launch_quantize(const void* x, const float* stats, uint8_t* words,
                     int64_t R, int64_t C, cudaStream_t stream) {
  constexpr int PER = 8 / SB;
  const int64_t CW = (C + PER - 1) / PER;
  const float half = ((1 << SB) - 1) / 2.0f;
  dim3 grid((unsigned)((CW + kThreads - 1) / kThreads), (unsigned)R);
  quantize_kernel<T, SB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, words, C, CW, half);
}

template <typename T, int SB>
void launch_dequantize(const uint8_t* words, const float* stats, void* out,
                       int64_t R, int64_t C, cudaStream_t stream) {
  constexpr int PER = 8 / SB;
  const int64_t CW = (C + PER - 1) / PER;
  const float half = ((1 << SB) - 1) / 2.0f;
  dim3 grid((unsigned)((CW + kThreads - 1) / kThreads), (unsigned)R);
  dequantize_kernel<T, SB><<<grid, kThreads, 0, stream>>>(
      words, stats, static_cast<T*>(out), C, CW, half);
}

template <typename T>
int dispatch_quantize(const void* x, const float* stats, uint8_t* words,
                      int64_t R, int64_t C, int bits, cudaStream_t s) {
  switch (bits) {
    case 1: launch_quantize<T, 1>(x, stats, words, R, C, s); break;
    case 2: launch_quantize<T, 2>(x, stats, words, R, C, s); break;
    case 4: launch_quantize<T, 4>(x, stats, words, R, C, s); break;
    case 8: launch_quantize<T, 8>(x, stats, words, R, C, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dequantize(const uint8_t* words, const float* stats, void* out,
                        int64_t R, int64_t C, int bits, cudaStream_t s) {
  switch (bits) {
    case 1: launch_dequantize<T, 1>(words, stats, out, R, C, s); break;
    case 2: launch_dequantize<T, 2>(words, stats, out, R, C, s); break;
    case 4: launch_dequantize<T, 4>(words, stats, out, R, C, s); break;
    case 8: launch_dequantize<T, 8>(words, stats, out, R, C, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, C) bf16 or fp32 row-major; stats (R, 2) fp32 (lo, hi); words
// (R, ceil(C / (8 / bits))) uint8.  Returns cudaGetLastError().
extern "C" int rdfsq_quantize(const void* x, int x_is_bf16, const void* stats,
                              void* words, long long R, long long C, int bits,
                              void* stream) {
  const float* st = static_cast<const float*>(stats);
  uint8_t* w = static_cast<uint8_t*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? dispatch_quantize<__nv_bfloat16>(x, st, w, R, C, bits, s)
                   : dispatch_quantize<float>(x, st, w, R, C, bits, s);
}

// words (R, ceil(C / (8 / bits))) uint8; stats (R, 2) fp32 (the payload's
// fp16 values); out (R, C) bf16 or fp32.  Returns cudaGetLastError().
extern "C" int rdfsq_dequantize(const void* words, const void* stats,
                                void* out, int out_is_bf16, long long R,
                                long long C, int bits, void* stream) {
  const uint8_t* w = static_cast<const uint8_t*>(words);
  const float* st = static_cast<const float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16
             ? dispatch_dequantize<__nv_bfloat16>(w, st, out, R, C, bits, s)
             : dispatch_dequantize<float>(w, st, out, R, C, bits, s);
}
