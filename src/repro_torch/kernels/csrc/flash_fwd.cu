// Causal flash-attention forward with runtime position masks, K1.
//
// Replaces src/repro/kernels/flash_kernel.py::forward (the Pallas kernel
// behind every prefill layer).
//
// Bound on the H100: at the serve shape (B 4, H 20, KH 5, Sq = Skv = 1024,
// D 64) the bytes it must move (bf16 q/k/v in, fp32 out, m, l) and its
// causal half of the bf16 operations give the same least time, about
// 0.011 ms; k/v tiles are reread from L2 by every q tile.  Design: one
// block of four warps per
// (q tile of 64 rows, head, batch row); the loop over kv tiles sits inside
// the block, because Hopper runs blocks in no order and cannot carry the
// (m, l, acc) state across a sequential grid axis as the TPU kernel does
// (flash_kernel.py:71-77).  The state stays in registers: each warp owns 16
// query rows, computes S = Q K^T and O += P V with mma.sync m16n8k16 (bf16
// operands, fp32 accumulation), and P goes from the S accumulators straight
// into the A operand of the PV product without touching shared memory.
// A kv tile whose position extrema make it invisible to the whole q tile is
// skipped (the reference's _visible); every score is then masked with the
// runtime qpos / kpos, so the +-2^30 sentinels of padding and kv_valid_len
// keep working.  Masked scores add exactly 0 to l, so a row with no visible
// key ends with l = 0 and out = acc / max(l, 1e-30) = 0.  GQA reads kv head
// h / (H / KH).  Simple first: no TMA, no wgmma, no double buffering.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim of q/k and of v
constexpr int kBQ = 64;       // query rows per block: 4 warps x 16
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

// D(16x8) += A(16x16, row-major) * B(16x8, col-major); bf16 in, fp32 acc.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool visible_pos(long long qp, long long kp,
                                            int has_window, int window) {
  return kp <= qp && (!has_window || qp - kp < window);
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

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KH,
    int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int has_window, int window) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBKV * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBKV * kLds];
  __shared__ int qp_s[kBQ];
  __shared__ int kp_s[kBKV];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;

  load_tile(q_s, qb, q_ss, q0, Sq, tid);
  if (tid < kBQ) qp_s[tid] = q0 + tid < Sq ? qpos[q0 + tid] : -kFar;
  __syncthreads();

  // q tile position extrema over its real rows (block-level skip test)
  long long qmin = kFar, qmax = -kFar;
  for (int i = 0; i < kBQ && q0 + i < Sq; ++i) {
    qmin = min(qmin, (long long)qp_s[i]);
    qmax = max(qmax, (long long)qp_s[i]);
  }
  const long long qp0 = qp_s[r0], qp1 = qp_s[r0 + 8];

  uint32_t qa[D / 16][4];  // A fragments of this warp's 16 x 64 q rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = q_s + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + r0 * kLds);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * kLds);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + r0 * kLds + 8);
    qa[kk][3] =
        *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * kLds + 8);
  }

  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int k0 = 0; k0 < Skv; k0 += kBKV) {
    __syncthreads();  // the previous tile's smem reads are done
    if (tid < kBKV) kp_s[tid] = k0 + tid < Skv ? kpos[k0 + tid] : kFar;
    __syncthreads();
    long long kmin = kFar, kmax = -kFar;
    for (int i = 0; i < kBKV && k0 + i < Skv; ++i) {
      kmin = min(kmin, (long long)kp_s[i]);
      kmax = max(kmax, (long long)kp_s[i]);
    }
    if (!(kmin <= qmax && (!has_window || kmax > qmin - window)))
      continue;  // uniform across the block
    load_tile(k_s, kb, k_ss, k0, Skv, tid);
    load_tile(v_s, vb, v_ss, k0, Skv, tid);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp: 8 n-tiles of 8 keys
    float s[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = k_s + (n * 8 + g) * kLds + kk * 16 + t * 2;
        mma_16816(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, row max, online-softmax update (rows r0: e = 0,1; r0+8: e = 2,3)
    uint32_t vis = 0u;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kp = kp_s[n * 8 + t * 2 + (e & 1)];
        if (visible_pos(e < 2 ? qp0 : qp1, kp, has_window, window)) {
          vis |= 1u << (n * 4 + e);
          if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
          else mx1 = fmaxf(mx1, s[n][e]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = (vis >> (n * 4 + e)) & 1u;
        const float p = on ? expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.0f;
        s[n][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P (bf16) from the S accumulators as A fragments
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = v_s + (kk * 16 + t * 2) * kLds + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* c = vr + n * 8;
        mma_16816(acc[n], pa, pack_bf16(c[0], c[kLds]),
                  pack_bf16(c[8 * kLds], c[9 * kLds]));
      }
    }
  }

  // out = acc / max(l, 1e-30); rows past Sq are not written
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0, row1 = q0 + r0 + 8;
  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < Sq) {
      ob[row0 * o_ss + col] = acc[n][0] / d0;
      ob[row0 * o_ss + col + 1] = acc[n][1] / d0;
    }
    if (row1 < Sq) {
      ob[row1 * o_ss + col] = acc[n][2] / d1;
      ob[row1 * o_ss + col + 1] = acc[n][3] / d1;
    }
  }
  if (t == 0) {
    const long long base = ((long long)b * H + h) * Sq;
    if (row0 < Sq) {
      m_out[base + row0] = m0;
      l_out[base + row0] = l0;
    }
    if (row1 < Sq) {
      m_out[base + row1] = m1;
      l_out[base + row1] = l1;
    }
  }
}

}  // namespace

// q (B, H, Sq, D), k / v (B, KH, Skv, D) bf16 given by pointer and element
// strides (batch, head, sequence; the last axis is contiguous, rows 16-byte
// aligned); qpos (Sq,), kpos (Skv,) int32; out (B, H, Sq, D) fp32 by
// strides; m / l (B, H, Sq) fp32 contiguous.  Returns cudaGetLastError().
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* m, void* l, int B, int H, int KH,
    int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int has_window, int window, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, KH, Sq, Skv, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      has_window, window);
  return (int)cudaGetLastError();
}
