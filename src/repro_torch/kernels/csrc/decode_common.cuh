// Single-token GQA decode attention over a ring cache: the per-block
// online-softmax sweep of K6 (bf16) and K7 (int8), decode.cu.  K8 / K9, the
// paged kernels, split each slot's pages over a thread-block cluster
// instead (decode_paged.cu).
//
// Replaces the body the Pallas kernels of
// src/repro/kernels/decode_kernel.py share (_decode_kernel,
// _decode_q8_kernel with _online_update): the TPU kernels carry (m, l,
// acc) in VMEM across a sequential grid axis over the cache; here one
// block of 128 threads owns one (row, kv head) and loops over the cache's
// tiles itself.
//
// Bound on the H100: bytes.  G = 4 query heads share each kv head, so each
// cache byte read feeds about 4 flops (8 for int8 codes), far below the
// ~295 flop/byte where the bf16 tensor cores become the limit.  The sweep
// therefore reads every visible key's K and V row once, with 16-byte loads,
// straight from where it lies in the ring row, and never touches a tile
// with no visible key.  Rows that are not visible are not read at all:
// their K and V stay 0 in shared memory, so their p = 0 adds exactly 0.
//
// Instantiated on the element type: bf16, or int8 codes whose
// per-(token, kv head) fp16 absmax scales fold into the two dots in the
// reference's order: s = (q . codes) * k_scale in fp32; softmax over s with
// l summing the unscaled p; (p * v_scale) rounded to bf16, then . codes in
// fp32.  The tiles are 64-row tiles of a (B, L, KH, D) ring cache, the
// last tile ragged (any L).
//
// Masked scores add exactly 0, so a row with no visible key (an inactive
// row, qpos = -1) returns 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int D = 64;        // head dim of q/k and of v
constexpr int kMaxG = 16;    // query heads per kv head
constexpr int kTile = 64;    // keys per tile of ring rows
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAccPerThread = kMaxG * D / kThreads;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One tile: its first token slot (the index into the flat token axis that
// the K/V rows, the scales and the positions share) and its row count.
struct Tile {
  long long slot0;
  int rows;
};

// The 64-row tiles of one batch row of a (B, L, KH, D) ring cache.
struct RingTiles {
  long long row0;  // b * L
  int L;
  __device__ __forceinline__ int count() const {
    return (L + kTile - 1) / kTile;
  }
  __device__ __forceinline__ Tile operator[](int j) const {
    return {row0 + (long long)j * kTile, min(kTile, L - j * kTile)};
  }
};

// The sweep of one (row, kv head) block.  q: (G, D) bf16, pre-scaled; k/v
// point at the flat (tokens, KH, D) cache; k_scale / v_scale at the flat
// (tokens, KH) fp16 scales (unused unless kScaled); pos at the (tokens,)
// key positions; out: (G, D) fp32.  Every thread of the block calls it.
template <typename Elem, bool kScaled>
__device__ __forceinline__ void sweep(
    const RingTiles& tiles, const __nv_bfloat16* __restrict__ q,
    const Elem* __restrict__ k, const Elem* __restrict__ v,
    const __half* __restrict__ k_scale, const __half* __restrict__ v_scale,
    const int* __restrict__ pos, int KH, int kh, int G, long long qp,
    int has_window, int window, float* __restrict__ out) {
  constexpr int kPerLoad = 16 / sizeof(Elem);  // elements per 16-byte load
  constexpr int kLoadsPerRow = D / kPerLoad;
  __shared__ float q_s[kMaxG][D];
  __shared__ float k_s[kTile][D + 1];
  __shared__ float v_s[kTile][D + 1];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ int valid_s[kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i / D][i % D] = __bfloat162float(q[i]);
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.0f;

  const int n_tiles = tiles.count();
  for (int j = 0; j < n_tiles; ++j) {
    const Tile tile = tiles[j];
    const int rows = tile.rows;
    bool valid = false;
    if (tid < kTile) {
      if (tid < rows) {
        const long long kp = pos[tile.slot0 + tid];
        valid = kp >= 0 && kp <= qp && (!has_window || qp - kp < window);
      }
      valid_s[tid] = valid;
      if constexpr (kScaled) {
        const long long at = (tile.slot0 + tid) * KH + kh;
        ks_s[tid] = valid ? __half2float(k_scale[at]) : 0.0f;
        vs_s[tid] = valid ? __half2float(v_scale[at]) : 0.0f;
      }
    }
    // also orders the previous tile's reads of k_s / v_s / p_s before the
    // loads below overwrite them
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < rows * kLoadsPerRow; i += kThreads) {
      const int t = i / kLoadsPerRow, c = (i % kLoadsPerRow) * kPerLoad;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = kw;
      if (valid_s[t]) {
        const long long at = ((tile.slot0 + t) * KH + kh) * D + c;
        kw = *reinterpret_cast<const uint4*>(k + at);
        vw = *reinterpret_cast<const uint4*>(v + at);
      }
      const Elem* ke = reinterpret_cast<const Elem*>(&kw);
      const Elem* ve = reinterpret_cast<const Elem*>(&vw);
#pragma unroll
      for (int e = 0; e < kPerLoad; ++e) {
        k_s[t][c + e] = to_float(ke[e]);
        v_s[t][c + e] = to_float(ve[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * rows; i += kThreads) {
      const int g = i / rows, t = i % rows;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[t][d];
      if constexpr (kScaled) s *= ks_s[t];  // fold the K absmax scale
      p_s[g][t] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // online softmax of row g
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = lane; t < rows; t += 32)
        if (valid_s[t]) mx = fmaxf(mx, p_s[g][t]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int t = lane; t < rows; t += 32) {
        const float p = valid_s[t] ? expf(p_s[g][t] - mx) : 0.0f;
        sum += p;  // l keeps the unscaled p
        // the PV product takes p (times the V scale) rounded to bf16, as
        // the reference
        const float pv = kScaled ? p * vs_s[t] : p;
        p_s[g][t] = __bfloat162float(__float2bfloat16_rn(pv));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int i = tid + a * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        float x = acc[a] * corr_s[g];
        for (int t = 0; t < rows; ++t) x += p_s[g][t] * v_s[t][d];
        acc[a] = x;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int i = tid + a * kThreads;
    if (i < G * D) out[i] = acc[a] / fmaxf(l_s[i / D], 1e-30f);
  }
}

}  // namespace decode
