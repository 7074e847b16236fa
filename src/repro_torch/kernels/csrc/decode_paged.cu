// Paged single-token GQA decode attention, K8.
//
// Replaces src/repro/kernels/decode_kernel.py::decode_paged (the Pallas
// kernel behind every decode tick of the serving engine).
//
// Bound on the H100: bytes.  One decode tick reads every live K/V page of
// every slot once and does 4 flops per byte read (G = 4 query heads share
// each kv head), far below the ~295 flop/byte where bf16 tensor cores
// become the limit.  Design: one block per (slot, kv head), looping over
// the slot's pages; each block reads its own page-table row (Hopper has no
// scalar prefetch), loads a page of K and V straight from where it lies in
// the pool into shared memory (no gathered copy of the cache), and keeps
// the online-softmax state (m, l, acc) in shared memory and registers
// across the page sweep.  A -1 page is clamped to page 0 for the load and
// masked out; a page with no visible key is skipped.  Masked scores add
// exactly 0, so a slot with qpos = -1 or no visible key returns 0, as the
// reference's _zero_fully_masked does.
//
// With S * KH = 4 * 5 = 20 blocks the card is mostly idle at the slice's
// shapes; splitting the page sweep across blocks (flash-decoding) is a later
// redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim of q/k and of v
constexpr int kMaxG = 16;    // query heads per kv head
constexpr int kMaxPage = 64; // tokens per page
constexpr int kThreads = 128;
constexpr int kAccPerThread = kMaxG * D / kThreads;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
    decode_paged_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ pos_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ qpos, float* __restrict__ out,
                        int KH, int G, int pg, int npp, int has_window,
                        int window) {
  __shared__ float q_s[kMaxG][D];
  __shared__ float k_s[kMaxPage][D + 1];
  __shared__ float v_s[kMaxPage][D];
  __shared__ float p_s[kMaxG][kMaxPage];
  __shared__ int valid_s[kMaxPage];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int slot = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const long long qp = qpos[slot];
  const __nv_bfloat16* qrow = q + ((long long)slot * KH + kh) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i / D][i % D] = __bfloat162float(qrow[i]);
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.0f;

  for (int pj = 0; pj < npp; ++pj) {
    const int entry = page_table[(long long)slot * npp + pj];
    const long long phys = entry < 0 ? 0 : entry;
    bool valid = false;
    if (tid < pg) {
      const long long kp = pos_pool[phys * pg + tid];
      valid = entry >= 0 && kp >= 0 && kp <= qp &&
              (!has_window || qp - kp < window);
      valid_s[tid] = valid;
    }
    // also orders the previous page's reads of k_s / v_s / p_s before the
    // loads below overwrite them
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < pg * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const long long src = ((phys * pg + t) * KH + kh) * D + d;
      k_s[t][d] = __bfloat162float(k_pool[src]);
      v_s[t][d] = __bfloat162float(v_pool[src]);
    }
    __syncthreads();
    for (int i = tid; i < G * pg; i += kThreads) {
      const int g = i / pg, t = i % pg;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[t][d];
      p_s[g][t] = s;
    }
    __syncthreads();
    if (tid < G) {  // online softmax of row g over this page
      const int g = tid;
      float mx = m_s[g];
      for (int t = 0; t < pg; ++t)
        if (valid_s[t]) mx = fmaxf(mx, p_s[g][t]);
      const float corr = expf(m_s[g] - mx);
      float sum = 0.0f;
      for (int t = 0; t < pg; ++t) {
        const float p = valid_s[t] ? expf(p_s[g][t] - mx) : 0.0f;
        sum += p;
        // the PV product takes p rounded to V's dtype, as the reference
        p_s[g][t] = __bfloat162float(__float2bfloat16_rn(p));
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      corr_s[g] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        float a = acc[j] * corr_s[g];
        for (int t = 0; t < pg; ++t) a += p_s[g][t] * v_s[t][d];
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  float* orow = out + ((long long)slot * KH + kh) * G * D;
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) orow[i] = acc[j] / fmaxf(l_s[i / D], 1e-30f);
  }
}

}  // namespace

// q (S, KH, G, D) bf16 pre-scaled; pools (P, pg, KH, D) bf16; pos_pool
// (P, pg) int32; page_table (S, npp) int32; qpos (S,) int32; out
// (S, KH, G, D) fp32.  Requires G <= 16, pg <= 64, D = 64 (the wrapper
// checks).  Returns cudaGetLastError().
extern "C" int decode_paged_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* pos_pool,
                                 const void* page_table, const void* qpos,
                                 void* out, int S, int KH, int G, int pg,
                                 int npp, int has_window, int window,
                                 void* stream) {
  if (G > kMaxG || pg > kMaxPage || S <= 0 || KH <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S, KH);
  decode_paged_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(pos_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(qpos), static_cast<float*>(out), KH, G, pg, npp,
      has_window, window);
  return (int)cudaGetLastError();
}
