// Flash-attention backward with runtime position masks: K2 (dQ) and K3
// (dK, dV).
//
// Replaces src/repro/kernels/flash_kernel.py::backward_dq (K2) and
// ::backward_dkv (K3), the Pallas kernels behind the custom VJP of
// flash_pallas (src/repro/kernels/attention_ops.py:62-106).  Both recompute
// the probabilities from the forward's saved row statistics,
//   P = exp(S - m) / max(l, 1e-30),  dP = dO V^T,  dS = P o (dP - delta),
// with delta = rowsum(dO o O) computed by the wrapper, and never hold an
// (Sq x Skv) tensor in device memory.  P and dS are rounded to bf16 before
// their products, as the reference rounds them; masked entries of P are
// exactly 0 (the port's forward convention, attention_ref.py).
//
// Bound on the H100 at the training shape (B 4, H 20, KH 5, Sq = Skv =
// 1024, D 64): operations.  K2 runs three products (S, dP, dQ), K3 four
// (S, dP, dV, dK), each over the causally visible (q, key) pairs only:
// about 16 and 21 GFLOP against some 48 and 38 MB of bytes to move.
//
// Design, simple first (no TMA, no wgmma, no double buffering):
// * K2: one block of four warps per (q tile of 64 rows, head, batch row)
//   loops over the kv tiles itself, since Hopper has no sequential grid
//   axis.  Each warp owns 16 query rows; S and dP are mma.sync m16n8k16
//   accumulators (bf16 operands, fp32 accumulation), dS is formed in those
//   registers and feeds the A operand of dQ += dS K straight from the
//   accumulator layout.  dQ stays in fp32 registers and is written once.
// * K3: one block per (kv tile of 64 rows, kv head, batch row) loops over
//   the G query heads of its group and every visible q tile, the TPU
//   kernel's kv-major order (flash_kernel.py:276-281).  Each warp owns 16
//   key rows and computes the transposed scores S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T land in the accumulator layout and feed
//   the A operand of dV += P^T dO and dK += dS^T Q without a trip through
//   shared memory; m, l and delta are then per column, read per q tile.
//   dK and dV stay in fp32 registers across the whole loop: no atomics,
//   and the result is the same from run to run.
// Both skip tiles that their position extrema make invisible (the
// reference's _visible), then mask every score with the runtime qpos /
// kpos, which covers the +-2^30 sentinels, kv_valid_len and the window.
#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ go,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ di_in, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ dq, int H, int KH,
    int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long go_sb, long long go_sh,
    long long go_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    int has_window, int window) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBKV * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBKV * kLds];
  __shared__ int qp_s[kBQ];
  __shared__ int kp_s[kBKV];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;
  load_tile(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq, tid);
  load_tile(do_s, go + b * go_sb + h * go_sh, go_ss, q0, Sq, tid);
  if (tid < kBQ) qp_s[tid] = q0 + tid < Sq ? qpos[q0 + tid] : -kFar;
  __syncthreads();

  long long qmin, qmax;
  extrema(qp_s, min(kBQ, Sq - q0), qmin, qmax);
  const long long qp0 = qp_s[r0], qp1 = qp_s[r0 + 8];

  // row statistics of rows r0, r0 + 8; rows past Sq see no key anyway
  const long long rbase = ((long long)b * H + h) * Sq;
  const int row0 = q0 + r0, row1 = row0 + 8;
  float m0 = 0.0f, m1 = 0.0f, li0 = 0.0f, li1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
  if (row0 < Sq) {
    m0 = m_in[rbase + row0];
    li0 = 1.0f / fmaxf(l_in[rbase + row0], 1e-30f);
    d0 = di_in[rbase + row0];
  }
  if (row1 < Sq) {
    m1 = m_in[rbase + row1];
    li1 = 1.0f / fmaxf(l_in[rbase + row1], 1e-30f);
    d1 = di_in[rbase + row1];
  }

  uint32_t qa[D / 16][4], da[D / 16][4];  // this warp's q and dO rows
  load_a_frags(qa, q_s, warp * 16, g, t);
  load_a_frags(da, do_s, warp * 16, g, t);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int k0 = 0; k0 < Skv; k0 += kBKV) {
    __syncthreads();  // the previous tile's smem reads are done
    if (tid < kBKV) kp_s[tid] = k0 + tid < Skv ? kpos[k0 + tid] : kFar;
    __syncthreads();
    long long kmin, kmax;
    extrema(kp_s, min(kBKV, Skv - k0), kmin, kmax);
    if (!tiles_visible(qmin, qmax, kmin, kmax, has_window, window))
      continue;  // uniform across the block
    load_tile(k_s, kb, k_ss, k0, Skv, tid);
    load_tile(v_s, vb, v_ss, k0, Skv, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys per warp
    float s[kBKV / 8][4], dp[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (n * 8 + g) * kLds + kk * 16 + t * 2;
        mma_16816(s[n], qa[kk], ld32(k_s + off), ld32(k_s + off + 8));
        mma_16816(dp[n], da[kk], ld32(v_s + off), ld32(v_s + off + 8));
      }
    }

    // P (exactly 0 where masked) and dS = P (dP - delta), into s
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const long long kp = kp_s[n * 8 + t * 2 + (e & 1)];
        const float p = visible_pos(lo ? qp0 : qp1, kp, has_window, window)
                            ? expf(s[n][e] - (lo ? m0 : m1)) * (lo ? li0 : li1)
                            : 0.0f;
        s[n][e] = p * (dp[n][e] - (lo ? d0 : d1));
      }
    }

    // dQ += dS K: dS (bf16) from the accumulators as A fragments
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
      const __nv_bfloat16* kr = k_s + (kk * 16 + t * 2) * kLds + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* c = kr + n * 8;
        mma_16816(acc[n], sa, pack_bf16(c[0], c[kLds]),
                  pack_bf16(c[8 * kLds], c[9 * kLds]));
      }
    }
  }

  float* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < Sq) {
      dqb[row0 * dq_ss + col] = acc[n][0];
      dqb[row0 * dq_ss + col + 1] = acc[n][1];
    }
    if (row1 < Sq) {
      dqb[row1 * dq_ss + col] = acc[n][2];
      dqb[row1 * dq_ss + col + 1] = acc[n][3];
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ go,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ di_in, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ dk,
    float* __restrict__ dv, int H, int KH, int Sq, int Skv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long go_sb, long long go_sh, long long go_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, int has_window, int window) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBKV * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBKV * kLds];
  __shared__ int qp_s[kBQ];
  __shared__ int kp_s[kBKV];
  __shared__ float m_s[kBQ], li_s[kBQ], di_s[kBQ];

  const int k0 = blockIdx.x * kBKV, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8

  load_tile(k_s, k + b * k_sb + kh * k_sh, k_ss, k0, Skv, tid);
  load_tile(v_s, v + b * v_sb + kh * v_sh, v_ss, k0, Skv, tid);
  if (tid < kBKV) kp_s[tid] = k0 + tid < Skv ? kpos[k0 + tid] : kFar;
  __syncthreads();

  long long kmin, kmax;
  extrema(kp_s, min(kBKV, Skv - k0), kmin, kmax);
  const long long kp0 = kp_s[r0], kp1 = kp_s[r0 + 8];

  uint32_t ka[D / 16][4], va[D / 16][4];  // this warp's k and v rows
  load_a_frags(ka, k_s, warp * 16, g, t);
  load_a_frags(va, v_s, warp * 16, g, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.0f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.0f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* gob = go + b * go_sb + h * go_sh;
    const long long rbase = ((long long)b * H + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's smem reads are done
      if (tid < kBQ) {
        const int r = q0 + tid;
        const bool in = r < Sq;  // rows past Sq see no key: P = 0
        qp_s[tid] = in ? qpos[r] : -kFar;
        m_s[tid] = in ? m_in[rbase + r] : 0.0f;
        li_s[tid] = in ? 1.0f / fmaxf(l_in[rbase + r], 1e-30f) : 0.0f;
        di_s[tid] = in ? di_in[rbase + r] : 0.0f;
      }
      __syncthreads();
      long long qmin, qmax;
      extrema(qp_s, min(kBQ, Sq - q0), qmin, qmax);
      if (!tiles_visible(qmin, qmax, kmin, kmax, has_window, window))
        continue;  // uniform across the block
      load_tile(q_s, qb, q_ss, q0, Sq, tid);
      load_tile(do_s, gob, go_ss, q0, Sq, tid);
      __syncthreads();

      // 32 query columns at a time keeps S^T and dP^T at 32 registers
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // S^T = K Q^T and dP^T = V dO^T: 16 key rows x 32 q columns
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
          dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int off = ((half * 4 + n) * 8 + g) * kLds + kk * 16 + t * 2;
            mma_16816(st[n], ka[kk], ld32(q_s + off), ld32(q_s + off + 8));
            mma_16816(dpt[n], va[kk], ld32(do_s + off),
                      ld32(do_s + off + 8));
          }
        }

        // P^T (exactly 0 where masked) into st, dS^T into dpt
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (half * 4 + n) * 8 + t * 2 + (e & 1);
            const long long kp = e < 2 ? kp0 : kp1;
            const float p =
                visible_pos(qp_s[c], kp, has_window, window)
                    ? expf(st[n][e] - m_s[c]) * li_s[c]
                    : 0.0f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - di_s[c]);
          }
        }

        // dV += P^T dO and dK += dS^T Q, A operands from the accumulators
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t pa[4], sa[4];
          acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
          const int qrow = half * 32 + kk * 16 + t * 2;
          const __nv_bfloat16* dor = do_s + qrow * kLds + g;
          const __nv_bfloat16* qr = q_s + qrow * kLds + g;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const __nv_bfloat16* c = dor + n * 8;
            mma_16816(dv_acc[n], pa, pack_bf16(c[0], c[kLds]),
                      pack_bf16(c[8 * kLds], c[9 * kLds]));
            c = qr + n * 8;
            mma_16816(dk_acc[n], sa, pack_bf16(c[0], c[kLds]),
                      pack_bf16(c[8 * kLds], c[9 * kLds]));
          }
        }
      }
    }
  }

  const int row0 = k0 + r0, row1 = row0 + 8;
  float* dkb = dk + b * dk_sb + kh * dk_sh;
  float* dvb = dv + b * dv_sb + kh * dv_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < Skv) {
      dkb[row0 * dk_ss + col] = dk_acc[n][0];
      dkb[row0 * dk_ss + col + 1] = dk_acc[n][1];
      dvb[row0 * dv_ss + col] = dv_acc[n][0];
      dvb[row0 * dv_ss + col + 1] = dv_acc[n][1];
    }
    if (row1 < Skv) {
      dkb[row1 * dk_ss + col] = dk_acc[n][2];
      dkb[row1 * dk_ss + col + 1] = dk_acc[n][3];
      dvb[row1 * dv_ss + col] = dv_acc[n][2];
      dvb[row1 * dv_ss + col + 1] = dv_acc[n][3];
    }
  }
}

bool bad_shape(int B, int H, int KH, int Sq, int Skv) {
  return B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
         B > 65535 || H > 65535;
}

}  // namespace

// K2.  q (B, H, Sq, D), k / v (B, KH, Skv, D), go (B, H, Sq, D) bf16 given
// by pointer and element strides (batch, head, sequence; the last axis is
// contiguous, rows 16-byte aligned); m / l / di (B, H, Sq) fp32
// contiguous; qpos (Sq,), kpos (Skv,) int32; dq (B, H, Sq, D) fp32 by
// strides.  Returns cudaGetLastError().
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* go,
    const void* m, const void* l, const void* di, const void* qpos,
    const void* kpos, void* dq, int B, int H, int KH, int Sq, int Skv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long go_sb, long long go_sh, long long go_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, int has_window,
    int window, void* stream) {
  if (bad_shape(B, H, KH, Sq, Skv)) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(go), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(di),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<float*>(dq), H, KH, Sq, Skv, q_sb, q_sh, q_ss, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss, go_sb, go_sh, go_ss, dq_sb, dq_sh, dq_ss,
      has_window, window);
  return (int)cudaGetLastError();
}

// K3.  Operands as K2; dk / dv (B, KH, Skv, D) fp32 by strides, each the
// sum over the G = H / KH query heads of the group.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* go,
    const void* m, const void* l, const void* di, const void* qpos,
    const void* kpos, void* dk, void* dv, int B, int H, int KH, int Sq,
    int Skv, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long go_sb, long long go_sh, long long go_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, int has_window, int window,
    void* stream) {
  if (bad_shape(B, H, KH, Sq, Skv) || KH > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Skv + kBKV - 1) / kBKV, KH, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(go), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(di),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<float*>(dk), static_cast<float*>(dv), H, KH, Sq, Skv, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, go_sb, go_sh, go_ss,
      dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, has_window, window);
  return (int)cudaGetLastError();
}
