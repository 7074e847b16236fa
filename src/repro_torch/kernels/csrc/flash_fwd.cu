// Causal flash-attention forward with runtime position masks, K1.
//
// Replaces src/repro/kernels/flash_kernel.py::forward (the Pallas kernel
// behind every prefill layer).
//
// Bound on the H100: at the serve shape (B 4, H 20, KH 5, Sq = Skv = 1024,
// D 64) the bytes it must move (bf16 q/k/v in, fp32 out, m, l) and its
// causal half of the bf16 operations give about the same least time,
// 0.011 ms; k/v tiles are reread from L2 by every q tile of a head.
//
// Design for Hopper.  One block per (q tile of 128 rows, head, batch row):
// two consumer warpgroups of 64 query rows each and one producer warp.
// - Before the roles split, the block finds the kv tiles that its q tile
//   can see from the position extrema (the reference's _visible) and lists
//   them in shared memory; invisible tiles are never loaded.
// - The producer warp's lane 0 loads the q tile once and keeps a ring of
//   kStages K/V tile pairs (64 keys each) filled with TMA, one "full" and
//   one "empty" mbarrier per stage.  q, k and v are strided views of
//   (B, S, H, D) buffers: each gets a 4-D tensor map over its own strides
//   (flash_attention passes transposed views, so nothing is copied), with
//   128-byte swizzle.
// - Each consumer warpgroup computes S = Q K^T with wgmma m64n64k16 (both
//   operands in shared memory), masks every score with the runtime qpos /
//   kpos (so the +-2^30 sentinels of padding and kv_valid_len keep
//   working) and the window, runs the online softmax in registers with
//   exp2f (log2 e folded into one multiply), then O += P V with wgmma, P
//   taken from the S accumulators rounded to bf16 in registers and V read
//   MN-major from shared memory (the transposed-B form).  It releases the
//   stage to the producer once its wgmmas are done.
// - The grid walks q tiles longest first (the last causal q tiles see the
//   most keys), so the short tiles fill in the tail.
// Masked scores add exactly 0 to l, so a row with no visible key ends with
// l = 0, m = -1e30 and out = acc / max(l, 1e-30) = 0.  GQA reads kv head
// h / (H / KH).  out, m and l are fp32.
//
// The q/k width D and the v width DV are template parameters, instantiated
// for (64, 64), (128, 128), MLA's (96, 64) (minicpm3_4b: qk_nope 64 +
// qk_rope 32, v 64) and (192, 128) (deepseek_v2_236b: qk_nope 128 +
// qk_rope 64, v 128), and (80, 80) (zamba2_2_7b's shared attention).  A
// tile of W columns is W / 64 column blocks of one 128-byte swizzle atom
// plus, where W is not a multiple of 64, one 32-column block of a 64-byte
// swizzle atom with its own tensor map (flash_common.cuh, Cols /
// load_rows): Q K^T steps its descriptors along the blocks over D
// (kmajor_desc: 4 k-steps a full block, 2 in the tail) and O += P V runs
// one m64n64 product per full block of V's DV columns (mma_mn; an m64n32
// for a tail).  At (128, 128) the block holds 129 KB of shared memory and
// 64 fp32 of O a thread; at (96, 64) 85 KB and 32; at (192, 128), three
// whole 128-byte blocks over D and no tail, 170 KB and 64 (the 12 k-steps
// of Q K^T add descriptors, not registers).  At (80, 80) every tile is
// kept 96 columns wide, TMA's zeros in the last 16 (flash_common.cuh):
// Q K^T runs the 5 k-steps that hold data, P V an m64n64 and an m64n32
// product into 48 fp32 of O a thread, of which the 40 of real columns are
// stored; 97 KB of shared memory.
// What is left: each warpgroup waits on its
// Q K^T before the softmax and on its P V before the next tile, so the
// tensor cores idle while a warpgroup's softmax runs unless the other
// warpgroups fill them.  Not yet: setmaxnreg, overlap of the softmax with
// the next Q K^T inside a warpgroup (FA3's ping-pong), a TMA store of out.
#include "flash_common.cuh"

namespace {

constexpr int kBQ = 128, kBKV = 64, kStages = 3;
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kFullTile = 1 << 30;  // list flag: every key visible to every
                                    // real row of the q tile

using flash::Axes;
using flash::exp2_approx;
using flash::kLog2e;
using flash::load_rows;
using flash::unpack_axes;

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap qtail,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap ktail,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap vtail, int q_axes, int k_axes,
    int v_axes, const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int KH, int Sq, int Skv,
    long long o_sb, long long o_sh, long long o_ss, int has_window,
    int window) {
  // bytes of the Q tile, of one K tile and of one V tile, each kept
  // Cols::kPad columns wide (zeros past D or DV, from TMA)
  constexpr int kQTile = kBQ * flash::Cols<D>::kPad * 2;
  constexpr int kKTile = kBKV * flash::Cols<D>::kPad * 2;
  constexpr int kVTile = kBKV * flash::Cols<DV>::kPad * 2;
  constexpr int kO = flash::Cols<DV>::kPad / 2;  // O accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1 024-aligned for the 128-byte swizzle; offset from smem_raw so that
  // the compiler still reads through it with shared-memory loads
  uint8_t* smem = smem_raw + ((1024u - hopper::smem_u32(smem_raw)) & 1023u);
  uint8_t* q_s = smem;                   // Cols<D> of 128 rows
  uint8_t* k_s = q_s + kQTile;           // [stage] Cols<D> of 64 rows
  uint8_t* v_s = k_s + kStages * kKTile;  // [stage] Cols<DV> of 64 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kVTile);
  uint64_t* qbar = bars;                        // 1
  uint64_t* full = bars + 1;                    // kStages
  uint64_t* empty = bars + 1 + kStages;         // kStages
  int* red = reinterpret_cast<int*>(bars + 1 + 2 * kStages);  // 2 x 9 + 1
  int* list = red + 20;                         // ceil(Skv / 64)

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (Skv + kBKV - 1) / kBKV;

  // q tile position extrema over its real rows
  {
    int lo = flash::kFar, hi = -flash::kFar;
    for (int r = tid; r < kBQ && q0 + r < Sq; r += kThreads) {
      const int p = qpos[q0 + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      red[warp] = lo;
      red[9 + warp] = hi;
    }
  }
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  long long qmin = flash::kFar, qmax = -flash::kFar;
  for (int w = 0; w < kThreads / 32; ++w) {
    qmin = min(qmin, (long long)red[w]);
    qmax = max(qmax, (long long)red[9 + w]);
  }
  // which kv tiles the q tile can see: one warp per tile
  for (int t = warp; t < nt; t += kThreads / 32) {
    int lo = flash::kFar, hi = -flash::kFar;
    for (int j = lane; j < kBKV; j += 32) {
      const int k = t * kBKV + j;
      if (k < Skv) {
        const int p = kpos[k];
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      const bool full = (t + 1) * kBKV <= Skv && hi <= qmin &&
                        (!has_window || qmax - lo < window);
      list[t] = !flash::tiles_visible(qmin, qmax, lo, hi, has_window, window)
                    ? -1
                    : t | (full ? kFullTile : 0);
    }
  }
  __syncthreads();
  if (tid == 0) {  // compact in place: the visible tiles in order
    int n = 0;
    for (int t = 0; t < nt; ++t)
      if (list[t] >= 0) list[n++] = list[t];
    red[18] = n;
  }
  __syncthreads();
  const int n_vis = red[18];

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------- producer warp
    if (lane == 0) {
      const Axes qa = unpack_axes(q_axes), ka = unpack_axes(k_axes),
                 va = unpack_axes(v_axes);
      hopper::mbar_expect_tx(qbar, kQTile);
      load_rows<D>(q_s, &qmap, &qtail, qbar, qa, q0, h, b, kBQ);
      for (int i = 0; i < n_vis; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[s], kKTile + kVTile);
        const int k0 = (list[i] & ~kFullTile) * kBKV;
        load_rows<D>(k_s + s * kKTile, &kmap, &ktail, &full[s], ka, k0, kh,
                     b, kBKV);
        load_rows<DV>(v_s + s * kVTile, &vmap, &vtail, &full[s], va, k0, kh,
                      b, kBKV);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = tid / 128, wt = tid % 128, wi = wt / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  const long long qp0 = row0 < Sq ? qpos[row0] : -flash::kFar;
  const long long qp1 = row1 < Sq ? qpos[row1] : -flash::kFar;

  float m0 = flash::kNeg, m1 = flash::kNeg, l0 = 0.0f, l1 = 0.0f;
  float o[kO], sc[32];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;

  hopper::mbar_wait(qbar, 0);

  for (int i = 0; i < n_vis; ++i) {
    const int s = i % kStages, entry = list[i];
    const int k0 = (entry & ~kFullTile) * kBKV;
    // the masks of a tile on the diagonal or the window's edge, from the
    // runtime positions, read while the tile lands
    uint32_t vis = 0xFFFFFFFFu;
    if (!(entry & kFullTile)) {
      vis = 0u;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + j * 8 + t4 * 2 + e;
          const long long kp = k < Skv ? kpos[k] : flash::kFar;
          if (flash::visible_pos(qp0, kp, has_window, window))
            vis |= 1u << (j * 4 + e);
          if (flash::visible_pos(qp1, kp, has_window, window))
            vis |= 1u << (j * 4 + 2 + e);
        }
      }
    }
    hopper::mbar_wait(&full[s], (i / kStages) & 1);

    // S = Q K^T: 64 rows x 64 keys per warpgroup, over the D / 16 k-steps
    // that hold data
    const uint8_t* kt = k_s + s * kKTile;
    hopper::wgmma_fence();
    hopper::fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64_ss<0>(sc,
                                 flash::kmajor_desc<D>(q_s, kBQ, wg * 64, kk),
                                 flash::kmajor_desc<D>(kt, kBKV, 0, kk),
                                 kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // row max and online-softmax update over the visible scores (element
    // 4 j + e: row r0 for e < 2, r0 + 8 otherwise; key 8 j + 2 t + (e & 1))
    float mx0 = flash::kNeg, mx1 = flash::kNeg;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((vis >> (j * 4 + e)) & 1u)) continue;
        if (e < 2) mx0 = fmaxf(mx0, sc[j * 4 + e]);
        else mx1 = fmaxf(mx1, sc[j * 4 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
    // (not an fma: m0 = mn0 = -1e30 must give exactly 1)
    const float corr0 = exp2_approx((m0 - mn0) * kLog2e);
    const float corr1 = exp2_approx((m1 - mn1) * kLog2e);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool on = (vis >> (j * 4 + e)) & 1u;
        const float p =
            on ? exp2_approx(fmaf(sc[j * 4 + e], kLog2e, e < 2 ? -b0 : -b1))
               : 0.0f;
        sc[j * 4 + e] = p;
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
    for (int j = 0; j < kO / 4; ++j) {
      o[j * 4] *= corr0;
      o[j * 4 + 1] *= corr0;
      o[j * 4 + 2] *= corr1;
      o[j * 4 + 3] *= corr1;
    }

    // O += P V: P (bf16) from the S accumulators as A fragments, V MN-major,
    // one product per 64 columns of O
    uint32_t pa[kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      flash::acc_to_a(pa[kk], &sc[kk * 8], &sc[kk * 8 + 4]);
    hopper::wgmma_fence();
    hopper::fence_regs(o);
    flash::mma_mn<DV>(o, pa, v_s + s * kVTile, kBKV);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[s]);
  }

  // out = o / max(l, 1e-30); rows past Sq and columns past DV are not
  // written
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * o_ss + col) =
          make_float2(o[j * 4] / d0, o[j * 4 + 1] / d0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + row1 * o_ss + col) =
          make_float2(o[j * 4 + 2] / d1, o[j * 4 + 3] / d1);
  }
  if (t4 == 0) {
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

namespace {

template <int D, int DV>
int launch_fwd(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, void* m, void* l, int B, int H,
               int KH, int Sq, int Skv, long long q_sb, long long q_sh,
               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss, long long o_sb,
               long long o_sh, long long o_ss, int has_window, int window,
               void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
      (long long)B * H > 0x7fffffffLL || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, qt, km, kt, vm, vt;
  const int qa = flash::map_operand(&qm, &qt, q, D, Sq, H, B, q_ss, q_sh,
                                    q_sb, kBQ);
  const int ka = flash::map_operand(&km, &kt, k, D, Skv, KH, B, k_ss, k_sh,
                                    k_sb, kBKV);
  const int va = flash::map_operand(&vm, &vt, v, DV, Skv, KH, B, v_ss, v_sh,
                                    v_sb, kBKV);
  if (qa < 0 || ka < 0 || va < 0) return (int)cudaErrorInvalidValue;
  const int nt = (Skv + kBKV - 1) / kBKV;
  constexpr int kD = flash::Cols<D>::kPad, kDV = flash::Cols<DV>::kPad;
  const int smem = 1024 + kBQ * kD * 2 + kStages * kBKV * (kD + kDV) * 2 +
                   (1 + 2 * kStages) * 8 + 20 * 4 + nt * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D, DV><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      qm, qt, km, kt, vm, vt, qa, ka, va, static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), H, KH, Sq, Skv, o_sb,
      o_sh, o_ss, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k (B, KH, Skv, D), v (B, KH, Skv, DV) bf16 given by
// pointer and element strides (batch, head, sequence; the last axis is
// contiguous, strides multiples of 8, bases 16-byte aligned), (D, DV) =
// (hd, dv), one of (64, 64), (128, 128), (96, 64), (192, 128), (80, 80);
// qpos (Sq,), kpos (Skv,) int32; out (B, H, Sq, DV) fp32 by strides;
// m / l (B, H, Sq) fp32 contiguous.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a width, shape or layout the kernel does not
// take).
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, void* out, void* m, void* l, int B, int H, int KH,
    int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int has_window, int window, int hd, int dv,
    void* stream) {
  auto run = [&](auto fn) {
    return fn(q, k, v, qpos, kpos, out, m, l, B, H, KH, Sq, Skv, q_sb, q_sh,
              q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
              has_window, window, stream);
  };
  if (hd == 64 && dv == 64) return run(launch_fwd<64, 64>);
  if (hd == 128 && dv == 128) return run(launch_fwd<128, 128>);
  if (hd == 96 && dv == 64) return run(launch_fwd<96, 64>);
  if (hd == 192 && dv == 128) return run(launch_fwd<192, 128>);
  if (hd == 80 && dv == 80) return run(launch_fwd<80, 80>);
  return (int)cudaErrorInvalidValue;
}
