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
// exactly 0 (the port's forward convention, attention_ref.py).  Both fold
// the row statistics into one number per row, lse2 = m log2 e +
// log2 max(l, 1e-30), so that P = exp2(S log2 e - lse2) costs one fma and
// one ex2 per score.
//
// Bound on the H100 at the training shape (B 4, H 20, KH 5, 793 positions
// padded to Sq = Skv = 1024, D 64): 80 x 314 821 visible (q, key) pairs.
// K2 runs three products over them (S, dP, dQ; 9.7 GFLOP, 0.0098 ms at
// 989 TFLOP/s) and moves some 48 MB (0.0144 ms at 3.35 TB/s): bytes.  K3
// runs four (S^T, dP^T, dV, dK; 12.9 GFLOP, 0.0130 ms) against some 38 MB
// (0.0113 ms): operations.
//
// Design for Hopper, on K1's skeleton (flash_fwd.cu): a producer warp
// keeps a ring of kStages tiles filled with TMA (4-D tensor maps over the
// strided (B, S, H, D) views, axes sorted by stride, 128-byte swizzle; one
// "full" and one "empty" mbarrier per stage), two consumer warpgroups run
// every product on wgmma m64n64k16, and the tiles a block can see are
// listed from the position extrema before the roles split, with a flag per
// warpgroup for "sees some key" and "every score visible" (which skips the
// per-score mask).  Neither kernel sums with atomics: dq, dk and dv are the
// same bits on every run.
// * K2: one block per (q tile of 128 rows, run of p heads of one GQA
//   group, batch row), q tiles longest first.  The producer loads each
//   head's Q and dO tiles once, into two slots so that the next head's land
//   during this one's sweep, and streams the visible K / V tile pairs (64
//   keys).  Each warpgroup (64 rows) computes S = Q K^T and dP = dO V^T
//   from shared memory, forms P and dS = P (dP - delta) in the
//   accumulators (m, l and delta of its rows in registers, fetched a head
//   ahead), rounds dS to bf16 A fragments in registers and runs dQ += dS K
//   with K read MN-major, K1's P V form.  Each head's dQ is written once.
// * K3: one block per (kv tile of 128 keys, run of p query heads, batch
//   row); the G / p blocks of one (kv tile, kv head, batch row) are one
//   thread block cluster (G / p <= 8), each sweeping its p heads in order.
//   kv tiles run longest first (tile 0 sees the most q tiles).  The
//   producer loads the K and V tiles once and streams (Q, dO) tile pairs of
//   64 rows over the visible q tiles; its lanes bring each pair's lse2,
//   delta and qpos (3 x 256 B) with plain loads into the stage.  Each
//   warpgroup (64 keys) computes S^T = K Q^T and dP^T = V dO^T, forms P^T
//   and dS^T in the accumulators and runs dV += P^T dO and dK += dS^T Q
//   with dO and Q read MN-major; dK and dV stay in fp32 registers across
//   the sweep.  After it, each block puts its partials in the ring's shared
//   memory and the cluster adds them through distributed shared memory in
//   rank order, each block a slice of the rows, written once.
// * p, the heads a block sweeps (attention_ops.py::bwd_heads_per_block):
//   the most, a divisor of G, for which the longest block's sweep stays
//   within the causal work per SM.  A block's fixed cost (listing its
//   tiles, its first loads, K3's cluster sum) idles its SM, since the
//   registers allow one block per SM; timing-only variants
//   (scripts/flash_bwd_variants.py, "no main loop") show it as a large
//   share of each kernel.  At the training shape p = 2 is faster than
//   p = 1 and p = 4, whose longest block sets the time (PERF.md §6); the
//   longest K3 block there sweeps 2 x 13 q tiles.
// Both issue S (S^T) and dP (dP^T) as two commit groups, so that the
// exponentials run under the second product; K3 issues dV before it forms
// dS^T.
//
// The q/k width D and the v width DV are template parameters, instantiated
// for (64, 64), (128, 128), MLA's (96, 64) and (192, 128), and zamba2's
// (80, 80).  A tile of W columns is W / 64 column blocks of one 128-byte
// swizzle atom plus, where W is not a multiple of 64, one 32-column block
// of a 64-byte swizzle atom with its own tensor map (flash_common.cuh,
// Cols / load_rows): the products that contract over D or DV step their
// descriptors along the blocks (kmajor_desc), and those whose output has D
// or DV columns (dQ, dK over D; dV over DV) run one m64n64 product per
// full block and an m64n32 for a tail (mma_mn).  Each tile and
// accumulator array is sized by its own width, rounded up to 32 columns
// (Cols::kPad): at (80, 80) the tiles are 96 wide with TMA's zeros in the
// last 16, S and dP (S^T and dP^T) step the 5 k-steps that hold data, and
// dQ, dK and dV keep 48 accumulators a thread of which 40 are stored.
// Where the padded D + DV passes 192 (at (128, 128)) K2 keeps a ring of 2
// stages (3 with its two Q / dO slots would pass the H100's 227 KB), and
// K3 holds the padded (D + DV) / 2 fp32 of dK and dV a thread (128 at
// (128, 128), 80 at (96, 64), 96 at (80, 80)).  At G 1 (MLA's
// materialised K / V, and zamba2's 32 / 32 heads: KH = H) K3's clusters
// are of one block, whose cluster sum reads only its own partials.
// At (192, 128) (deepseek_v2_236b's MLA, G 1, so p = 1):
// * K2 keeps one Q / dO slot and 3 ring stages (206 KB): two slots would
//   need 247 KB, and at p = 1 the second has no next head to hold.  Each
//   thread holds 96 fp32 of dQ beside the 32 of S and the 32 of dP.
// * K3 would hold 160 fp32 of dK / dV a thread, which with the S^T and
//   dP^T tiles and their A fragments passes the 255-register limit.  So
//   both warpgroups take the same 64 keys (a block's kv tile is 64 keys)
//   and split the output columns: warpgroup w keeps dK[:, 96 w, 96 w + 96)
//   and dV[:, 64 w, 64 w + 64), 80 fp32, the load of (96, 64).  Each
//   computes S^T and dP^T for the 64 keys itself, which repeats those two
//   products (half as much tensor work again as one warpgroup a 64 keys)
//   but needs no exchange between the warpgroups; sharing P^T and dS^T
//   through shared memory as bf16 would cost a barrier between them every
//   tile.
//   Q lands as a narrow tile (six 32-column blocks of 64-byte swizzle,
//   flash_common.cuh), so a warpgroup's 96 dK columns are three m64n32
//   products on whole blocks; dO's 128-byte blocks split 64 / 64.  The
//   ring holds 3 stages of (Q, dO) beside K and V: 167 KB in all.
// What is left: a block's fixed cost is still paid 2 - 3 times per SM
// (a persistent grid would overlap it with the previous tile's sweep);
// each warpgroup waits on its products before the next tile (an FA3
// ping-pong of the two warpgroups measured no gain); no setmaxnreg;
// delta = rowsum(dO o O) is a separate PyTorch reduction and could be
// fused into K2; a fused backward with a deterministic order of dQ sums
// would run S and dP once for both.
#include <cooperative_groups.h>
#include <math_constants.h>

#include "flash_common.cuh"

namespace {

namespace cg = cooperative_groups;
using flash::kFar;
using flash::kLog2e;

constexpr int kStages = 3;
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kDqRows = 128, kDqKeys = 64;    // K2 tiles
constexpr int kDkvKeys = 128, kDkvRows = 64;  // K3 tiles
constexpr int kMaxCluster = 8;
// list entry: the tile in the low 24 bits; per warpgroup w, bit 24 + 2 w
// "sees some score" and bit 25 + 2 w "sees every score"
constexpr int kTileBits = (1 << 24) - 1;
constexpr int kRed = 8;  // ints of scratch before the list

__device__ __forceinline__ int sees_flag(int wg) { return 1 << (24 + 2 * wg); }
__device__ __forceinline__ int full_flag(int wg) { return 1 << (25 + 2 * wg); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Compacts list[0 .. n) in place to its entries >= 0, in order, with one
// warp; returns their count to every lane.
__device__ __forceinline__ int compact_list(int* list, int n, int lane) {
  int kept = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + lane < n ? list[base + lane] : -1;
    const unsigned keep = __ballot_sync(0xffffffffu, e >= 0);
    if (e >= 0) list[kept + __popc(keep & ((1u << lane) - 1u))] = e;
    kept += __popc(keep);
    __syncwarp();
  }
  return kept;
}

// lse2 of one row: P = exp2(S log2 e - lse2).
__device__ __forceinline__ float row_lse2(float m, float l) {
  return m * kLog2e + log2f(fmaxf(l, 1e-30f));
}

// Shared-memory layouts (bytes from the 1 024-aligned base), the host's
// sizes included (attention_ops.py::flash_bwd_plan).
// Tiles and accumulators take Cols::kPad columns (96 at width 80).
template <int D, int DV>
struct DqSmem {
  static constexpr int kD = flash::Cols<D>::kPad, kDV = flash::Cols<DV>::kPad;
  static constexpr int kQ = kDqRows * kD * 2, kG = kDqRows * kDV * 2;
  static constexpr int kK = kDqKeys * kD * 2, kV = kDqKeys * kDV * 2;
  // Q / dO slots (with two, the next head's land during this one's sweep)
  // and K / V ring stages: (2, 3) up to kD + kDV = 192 (at (80, 80) too),
  // (2, 2) up to 256 (at (128, 128)), (1, 3) above (at (192, 128), whose
  // two slots alone would take 160 KB)
  static constexpr int kSlots = kD + kDV > 256 ? 1 : 2;
  static constexpr int kSt = kD + kDV > 192 && kSlots == 2 ? 2 : kStages;
  static constexpr int q = 0, go = kQ, slot = kQ + kG;
  static constexpr int k = kSlots * slot, v = k + kSt * kK;
  static constexpr int bars = v + kSt * kV;
  static constexpr int red = bars + (4 + 2 * kSt) * 8;
  static constexpr int list = red + kRed * 4;
  static int bytes(int n_tiles) { return 1024 + list + n_tiles * 4; }
};

template <int D, int DV>
struct DkvSmem {
  static constexpr int kD = flash::Cols<D>::kPad, kDV = flash::Cols<DV>::kPad;
  // split: both warpgroups take the same 64 keys, each half of dK's and of
  // dV's columns, with Q kept as a narrow tile (at (192, 128), where
  // (D + Dv) / 2 = 160 fp32 of dK / dV a thread would spill)
  static constexpr bool kSplit = kD + kDV > 256;
  static constexpr int kKeys = kSplit ? 64 : kDkvKeys;  // keys a block
  static constexpr int kK = kKeys * kD * 2, kV = kKeys * kDV * 2;
  static constexpr int kQ = kDkvRows * kD * 2, kG = kDkvRows * kDV * 2;
  // partial row strides, floats (the real columns only)
  static constexpr int kLdk = D + 8, kLdv = DV + 8;
  static constexpr int kStat = 3 * kDkvRows * 4;  // lse2, delta, qpos
  static constexpr int k = 0, v = kK, q = kK + kV, go = q + kStages * kQ;
  static constexpr int ring = go + kStages * kG;
  // the partials, bytes: dK's then dV's
  static constexpr int part_k = kKeys * kLdk * 4;
  static constexpr int part_v = kKeys * kLdv * 4;
  static_assert(part_k + part_v <= ring, "the partials overlay the tiles");
  static constexpr int stat = ring;
  static constexpr int bars = stat + kStages * kStat;
  static constexpr int red = bars + (1 + 2 * kStages) * 8;
  static constexpr int list = red + kRed * 4;
  static int bytes(int n_tiles) { return 1024 + list + n_tiles * 4; }
};

// ------------------------------------------------------------------ K2 ---

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap qtail,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap ktail,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap vtail,
    const __grid_constant__ CUtensorMap gomap,
    const __grid_constant__ CUtensorMap gotail, int q_axes, int k_axes,
    int v_axes, int go_axes, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ di_in,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dq, int H, int KH, int Sq, int Skv, long long dq_sb,
    long long dq_sh, long long dq_ss, int has_window, int window, int hpb) {
  using L = DqSmem<D, DV>;
  constexpr int kSt = L::kSt, kSlots = L::kSlots;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - hopper::smem_u32(smem_raw)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* qfull = bars;       // kSlots (of 2 reserved): the Q / dO slots
  uint64_t* qempty = bars + 2;  // kSlots (of 2)
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + kSt;
  int* red = reinterpret_cast<int*>(smem + L::red);
  int* list = reinterpret_cast<int*>(smem + L::list);

  // the block's heads h0 .. h0 + hpb - 1 share one kv head (hpb divides G)
  const int groups = H / hpb;
  const int h0 = (blockIdx.x % groups) * hpb, b = blockIdx.x / groups;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // longest first
  const int kh = h0 / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (Skv + kDqKeys - 1) / kDqKeys;
  const int wg = tid / 128, wi = (tid % 128) / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  // a consumer's m, l, delta of rows row0 / row1 of the next head, fetched
  // a head ahead (the first while the block lists its tiles)
  float raw[6];
  auto fetch = [&](int h) {
    const long long base = ((long long)b * H + h) * Sq;
    const bool in0 = row0 < Sq, in1 = row1 < Sq;
    raw[0] = in0 ? m_in[base + row0] : 0.0f;
    raw[1] = in0 ? l_in[base + row0] : 0.0f;
    raw[2] = in0 ? di_in[base + row0] : 0.0f;
    raw[3] = in1 ? m_in[base + row1] : 0.0f;
    raw[4] = in1 ? l_in[base + row1] : 0.0f;
    raw[5] = in1 ? di_in[base + row1] : 0.0f;
  };
  if (tid < kConsumers) fetch(h0);
  const flash::Axes qa = flash::unpack_axes(q_axes),
                    ga = flash::unpack_axes(go_axes);
  auto load_q = [&](int j) {  // head h0 + j's Q and dO into its slot
    const int slot = j % kSlots;
    hopper::mbar_expect_tx(&qfull[slot], L::kQ + L::kG);
    flash::load_rows<D>(smem + L::q + slot * L::slot, &qmap, &qtail,
                        &qfull[slot], qa, q0, h0 + j, b, kDqRows);
    flash::load_rows<DV>(smem + L::go + slot * L::slot, &gomap, &gotail,
                         &qfull[slot], ga, q0, h0 + j, b, kDqRows);
  };

  // position extrema of each warpgroup's 64 rows
  if (warp < 2) {
    int lo, hi;
    flash::warp_extrema(qpos, q0 + 64 * warp, Sq, lane, lo, hi);
    if (lane == 0) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  if (tid == 0) {
    for (int j = 0; j < kSlots; ++j) {
      hopper::mbar_init(&qfull[j], 1);
      hopper::mbar_init(&qempty[j], kConsumers);
    }
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == kConsumers) load_q(0);  // lands while the tiles are listed
  // which kv tiles each warpgroup can see (the same for every head): one
  // warp per tile
  for (int t = warp; t < nt; t += kThreads / 32) {
    int lo, hi;
    flash::warp_extrema(kpos, t * kDqKeys, Skv, lane, lo, hi);
    if (lane == 0) {
      int entry = t;
      for (int w = 0; w < 2; ++w) {
        const long long qlo = red[2 * w], qhi = red[2 * w + 1];
        if (flash::tiles_visible(qlo, qhi, lo, hi, has_window, window))
          entry |= sees_flag(w);
        if ((t + 1) * kDqKeys <= Skv &&
            flash::tiles_all_visible(qlo, qhi, lo, hi, has_window, window))
          entry |= full_flag(w);
      }
      list[t] = entry > kTileBits ? entry : -1;
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact in place: the visible tiles in order
    const int n = compact_list(list, nt, lane);
    if (lane == 0) red[4] = n;
  }
  __syncthreads();
  const int n_vis = red[4];

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------- producer warp
    if (lane == 0) {
      const flash::Axes ka = flash::unpack_axes(k_axes),
                        va = flash::unpack_axes(v_axes);
      int it = 0;  // ring position, over the heads' sweeps
      for (int j = 0; j < hpb; ++j) {
        if (j >= kSlots)
          hopper::mbar_wait(&qempty[j % kSlots], (j / kSlots - 1) & 1);
        if (j > 0) load_q(j);
        for (int i = 0; i < n_vis; ++i, ++it) {
          const int s = it % kSt;
          if (it >= kSt) hopper::mbar_wait(&empty[s], (it / kSt - 1) & 1);
          hopper::mbar_expect_tx(&full[s], L::kK + L::kV);
          const int k0 = (list[i] & kTileBits) * kDqKeys;
          flash::load_rows<D>(smem + L::k + s * L::kK, &kmap, &ktail,
                              &full[s], ka, k0, kh, b, kDqKeys);
          flash::load_rows<DV>(smem + L::v + s * L::kV, &vmap, &vtail,
                               &full[s], va, k0, kh, b, kDqKeys);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const long long qp0 = row0 < Sq ? qpos[row0] : -kFar;
  const long long qp1 = row1 < Sq ? qpos[row1] : -kFar;
  int it = 0;
  for (int j = 0; j < hpb; ++j) {
    const int slot = j % kSlots, h = h0 + j;
    // rows past Sq: lse2 = +inf gives P = 0
    const float lse0 = row0 < Sq ? row_lse2(raw[0], raw[1]) : CUDART_INF_F;
    const float lse1 = row1 < Sq ? row_lse2(raw[3], raw[4]) : CUDART_INF_F;
    const float d0 = raw[2], d1 = raw[5];
    if (j + 1 < hpb) fetch(h + 1);

    float acc[L::kD / 2], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < L::kD / 2; ++i) acc[i] = 0.0f;
    hopper::mbar_wait(&qfull[slot], (j / kSlots) & 1);
    const uint8_t* qt = smem + L::q + slot * L::slot;
    const uint8_t* gt = smem + L::go + slot * L::slot;

    for (int i = 0; i < n_vis; ++i, ++it) {
      const int s = it % kSt, entry = list[i];
      if (!(entry & sees_flag(wg))) {  // nothing visible to these rows
        hopper::mbar_wait(&full[s], (it / kSt) & 1);
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const int k0 = (entry & kTileBits) * kDqKeys;
      // the masks of a tile on the diagonal or the window's edge, read
      // while the tile lands (element 4 j + e: row r0 for e < 2, r0 + 8
      // otherwise; key 8 j + 2 t + (e & 1))
      uint32_t vis = 0xFFFFFFFFu;
      if (!(entry & full_flag(wg))) {
        vis = 0u;
#pragma unroll
        for (int jj = 0; jj < kDqKeys / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + jj * 8 + t4 * 2 + e;
            const long long kp = k < Skv ? kpos[k] : kFar;
            if (flash::visible_pos(qp0, kp, has_window, window))
              vis |= 1u << (jj * 4 + e);
            if (flash::visible_pos(qp1, kp, has_window, window))
              vis |= 1u << (jj * 4 + 2 + e);
          }
        }
      }
      hopper::mbar_wait(&full[s], (it / kSt) & 1);

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys per warpgroup, over
      // the k-steps that hold data, in two commit groups: P is formed while
      // dP is still running
      const uint8_t* kt = smem + L::k + s * L::kK;
      const uint8_t* vt = smem + L::v + s * L::kV;
      hopper::wgmma_fence();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64_ss<0>(
            sc, flash::kmajor_desc<D>(qt, kDqRows, wg * 64, kk),
            flash::kmajor_desc<D>(kt, kDqKeys, 0, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        hopper::wgmma_m64n64_ss<0>(
            dp, flash::kmajor_desc<DV>(gt, kDqRows, wg * 64, kk),
            flash::kmajor_desc<DV>(vt, kDqKeys, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);

      // P, exactly 0 where masked
#pragma unroll
      for (int jj = 0; jj < kDqKeys / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[jj * 4 + e] =
              (vis >> (jj * 4 + e)) & 1u
                  ? flash::exp2_approx(fmaf(sc[jj * 4 + e], kLog2e,
                                            e < 2 ? -lse0 : -lse1))
                  : 0.0f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      // dS = P (dP - delta)
#pragma unroll
      for (int jj = 0; jj < kDqKeys / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[jj * 4 + e] *= dp[jj * 4 + e] - (e < 2 ? d0 : d1);
      }

      // dQ += dS K: dS (bf16) from the accumulators as A fragments, K read
      // MN-major, one product per block of dQ's D columns
      uint32_t da[kDqKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        flash::acc_to_a(da[kk], &sc[kk * 8], &sc[kk * 8 + 4]);
      hopper::wgmma_fence();
      hopper::fence_regs(acc);
      flash::mma_mn<D>(acc, da, kt, kDqKeys);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }
    hopper::mbar_arrive(&qempty[slot]);  // its products have retired

    // rows past Sq and columns past D are not written
    float* out = dq + b * dq_sb + h * dq_sh;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = jj * 8 + t4 * 2;
      if (row0 < Sq)
        *reinterpret_cast<float2*>(out + row0 * dq_ss + col) =
            make_float2(acc[jj * 4], acc[jj * 4 + 1]);
      if (row1 < Sq)
        *reinterpret_cast<float2*>(out + row1 * dq_ss + col) =
            make_float2(acc[jj * 4 + 2], acc[jj * 4 + 3]);
    }
  }
}

// ------------------------------------------------------------------ K3 ---

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap qtail,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap ktail,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap vtail,
    const __grid_constant__ CUtensorMap gomap,
    const __grid_constant__ CUtensorMap gotail, int q_axes, int k_axes,
    int v_axes, int go_axes, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ di_in,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dk, float* __restrict__ dv, int H, int KH, int Sq,
    int Skv, long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss, int has_window,
    int window) {
  using L = DkvSmem<D, DV>;
  constexpr bool kSplit = L::kSplit;
  static_assert(!kSplit || (D % 64 == 0 && DV % 128 == 0),
                "a split warpgroup takes whole narrow blocks of Q and whole "
                "128-byte blocks of dO");
  // the dK / dV columns a warpgroup keeps (kNk, kNv) and the accumulators
  // it holds for them (kAk, kAv: Cols::kPad wide unless split)
  constexpr int kNk = kSplit ? D / 2 : D, kNv = kSplit ? DV / 2 : DV;
  constexpr int kAk = kSplit ? kNk : L::kD, kAv = flash::Cols<kNv>::kPad;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - hopper::smem_u32(smem_raw)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  int* red = reinterpret_cast<int*>(smem + L::red);
  int* list = reinterpret_cast<int*>(smem + L::list);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c, kh = grp % KH, b = grp / KH;
  const int k0 = blockIdx.y * L::kKeys;  // tile 0 sees the most q tiles
  const int gpb = H / KH / c;            // query heads per block
  const int h_first = kh * (H / KH) + rank * gpb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + kDkvRows - 1) / kDkvRows;

  // position extrema of each warpgroup's 64 keys (split: the same 64)
  if (warp < 2) {
    int lo, hi;
    flash::warp_extrema(kpos, k0 + (kSplit ? 0 : 64 * warp), Skv, lane, lo,
                        hi);
    if (lane == 0) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == kConsumers) {  // lands while the tiles are listed
    hopper::mbar_expect_tx(kvbar, L::kK + L::kV);
    flash::load_rows<D>(smem + L::k, &kmap, &ktail, kvbar,
                        flash::unpack_axes(k_axes), k0, kh, b, L::kKeys);
    flash::load_rows<DV>(smem + L::v, &vmap, &vtail, kvbar,
                         flash::unpack_axes(v_axes), k0, kh, b, L::kKeys);
  }
  // which q tiles each warpgroup's keys can see: one warp per tile
  for (int t = warp; t < nq; t += kThreads / 32) {
    int lo, hi;
    flash::warp_extrema(qpos, t * kDkvRows, Sq, lane, lo, hi);
    if (lane == 0) {
      int entry = t;
      for (int w = 0; w < 2; ++w) {
        const long long klo = red[2 * w], khi = red[2 * w + 1];
        if (flash::tiles_visible(lo, hi, klo, khi, has_window, window))
          entry |= sees_flag(w);
        if ((t + 1) * kDkvRows <= Sq &&
            flash::tiles_all_visible(lo, hi, klo, khi, has_window, window))
          entry |= full_flag(w);
      }
      list[t] = entry > kTileBits ? entry : -1;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n = compact_list(list, nq, lane);
    if (lane == 0) red[4] = n;
  }
  __syncthreads();
  const int n_list = red[4], total = gpb * n_list;

  float dka[kAk / 2], dva[kAv / 2];
#pragma unroll
  for (int i = 0; i < kAk / 2; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kAv / 2; ++i) dva[i] = 0.0f;
  const int wg = tid / 128, wi = (tid % 128) / 32;
  const int g = lane >> 2, t4 = lane & 3;

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------- producer warp
    const flash::Axes qa = flash::unpack_axes(q_axes),
                      ga = flash::unpack_axes(go_axes);
    for (int i = 0; i < total; ++i) {
      const int s = i % kStages, h = h_first + i / n_list;
      const int q0 = (list[i % n_list] & kTileBits) * kDkvRows;
      // the pair's row statistics, loaded before the stage frees; rows
      // past Sq see no key
      const long long rbase = ((long long)b * H + h) * Sq;
      float lse[2], d[2];
      int qp[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + lane + 32 * u;
        lse[u] = CUDART_INF_F;
        d[u] = 0.0f;
        qp[u] = -kFar;
        if (row < Sq) {
          lse[u] = row_lse2(m_in[rbase + row], l_in[rbase + row]);
          d[u] = di_in[rbase + row];
          qp[u] = qpos[row];
        }
      }
      if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      if (lane == 0) {
        hopper::mbar_add_tx(&full[s], L::kQ + L::kG);
        if constexpr (kSplit)  // qtail is the 32-column map
          flash::load_narrow<D>(smem + L::q + s * L::kQ, &qtail, &full[s],
                                qa, q0, h, b, kDkvRows);
        else
          flash::load_rows<D>(smem + L::q + s * L::kQ, &qmap, &qtail,
                              &full[s], qa, q0, h, b, kDkvRows);
        flash::load_rows<DV>(smem + L::go + s * L::kG, &gomap, &gotail,
                             &full[s], ga, q0, h, b, kDkvRows);
      }
      float* st = reinterpret_cast<float*>(smem + L::stat + s * L::kStat);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        st[lane + 32 * u] = lse[u];
        st[kDkvRows + lane + 32 * u] = d[u];
        reinterpret_cast<int*>(st)[2 * kDkvRows + lane + 32 * u] = qp[u];
      }
      hopper::mbar_arrive(&full[s]);  // after this lane's stores
    }
  } else {
    // ---------------------------------------------- consumer warpgroups
    const int krow = kSplit ? 0 : wg * 64;  // the warpgroup's first key
    const int key0 = k0 + krow + wi * 16 + g, key1 = key0 + 8;
    const long long kp0 = key0 < Skv ? kpos[key0] : kFar;
    const long long kp1 = key1 < Skv ? kpos[key1] : kFar;
    float sc[32], dp[32];
    hopper::mbar_wait(kvbar, 0);

    for (int i = 0; i < total; ++i) {
      const int s = i % kStages, entry = list[i % n_list];
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      if (!(entry & sees_flag(wg))) {  // nothing visible to these keys
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const float* st =
          reinterpret_cast<const float*>(smem + L::stat + s * L::kStat);
      const int* qps = reinterpret_cast<const int*>(st + 2 * kDkvRows);
      // element 4 j + e: key row r0 for e < 2, r0 + 8 otherwise; q row
      // 8 j + 2 t + (e & 1) of the tile
      uint32_t vis = 0xFFFFFFFFu;
      if (!(entry & full_flag(wg))) {
        vis = 0u;
#pragma unroll
        for (int j = 0; j < kDkvRows / 8; ++j) {
          const int2 qp = *reinterpret_cast<const int2*>(qps + j * 8 + t4 * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long q = (e & 1) ? qp.y : qp.x;
            if (flash::visible_pos(q, e < 2 ? kp0 : kp1, has_window, window))
              vis |= 1u << (j * 4 + e);
          }
        }
      }

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows per warpgroup
      const uint8_t* qt = smem + L::q + s * L::kQ;
      const uint8_t* gt = smem + L::go + s * L::kG;
      // three commit groups: P^T is formed while dP^T runs, dS^T while
      // dV += P^T dO runs
      hopper::wgmma_fence();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64_ss<0>(
            sc, flash::kmajor_desc<D>(smem + L::k, L::kKeys, krow, kk),
            kSplit ? flash::narrow_kdesc(qt, kDkvRows, 0, kk)
                   : flash::kmajor_desc<D>(qt, kDkvRows, 0, kk),
            kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        hopper::wgmma_m64n64_ss<0>(
            dp, flash::kmajor_desc<DV>(smem + L::v, L::kKeys, krow, kk),
            flash::kmajor_desc<DV>(gt, kDkvRows, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);

      // P^T, exactly 0 where masked (element 4 j + e: q row
      // 8 j + 2 t + (e & 1)), kept in sc for dS^T
#pragma unroll
      for (int j = 0; j < kDkvRows / 8; ++j) {
        const float2 lse =
            *reinterpret_cast<const float2*>(st + j * 8 + t4 * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j * 4 + e] = (vis >> (j * 4 + e)) & 1u
                              ? flash::exp2_approx(fmaf(
                                    sc[j * 4 + e], kLog2e,
                                    (e & 1) ? -lse.y : -lse.x))
                              : 0.0f;
      }
      // dV += P^T dO: P^T (bf16) from the accumulators as A fragments, dO
      // read MN-major, one product per block of the warpgroup's dV columns
      uint32_t pa[kDkvRows / 16][4], sa[kDkvRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk)
        flash::acc_to_a(pa[kk], &sc[kk * 8], &sc[kk * 8 + 4]);
      hopper::wgmma_fence();
      hopper::fence_regs(dva);
      if constexpr (kSplit)  // dO's 128-byte blocks of this half
        flash::mma_mn<kNv>(dva, pa, gt + wg * (kNv / 64) * kDkvRows * 128,
                           kDkvRows);
      else
        flash::mma_mn<DV>(dva, pa, gt, kDkvRows);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dP^T (groups retire in order)
      hopper::fence_regs(dp);

      // dK += dS^T Q, dS^T = P^T (dP^T - delta), Q read MN-major
#pragma unroll
      for (int j = 0; j < kDkvRows / 8; ++j) {
        const float2 dd =
            *reinterpret_cast<const float2*>(st + kDkvRows + j * 8 + t4 * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j * 4 + e] =
              sc[j * 4 + e] * (dp[j * 4 + e] - ((e & 1) ? dd.y : dd.x));
      }
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk)
        flash::acc_to_a(sa[kk], &dp[kk * 8], &dp[kk * 8 + 4]);
      hopper::wgmma_fence();
      hopper::fence_regs(dka);
      if constexpr (kSplit)  // Q's narrow blocks of this half
        flash::mma_narrow<kNk>(dka, sa, qt, kDkvRows, wg * (kNk / 32));
      else
        flash::mma_mn<D>(dka, sa, qt, kDkvRows);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      // the A fragments stay put until the products reading them retire
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk) {
        hopper::keep_regs(pa[kk]);
        hopper::keep_regs(sa[kk]);
      }
      hopper::mbar_arrive(&empty[s]);
    }

    // the block's partials (their real columns), over the tiles every
    // consumer is done with
    consumers_sync();
    float* part_k = reinterpret_cast<float*>(smem);
    float* part_v = part_k + L::kKeys * L::kLdk;
    const int r0 = krow + wi * 16 + g;
    // the warpgroup's first dK / dV column (split: its half)
    const int ck = kSplit ? wg * kNk : 0, cv = kSplit ? wg * kNv : 0;
#pragma unroll
    for (int j = 0; j < kNk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(part_k + (r0 + 4 * e) * L::kLdk + ck +
                                   j * 8 + t4 * 2) =
            make_float2(dka[j * 4 + e], dka[j * 4 + e + 1]);
    }
#pragma unroll
    for (int j = 0; j < kNv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(part_v + (r0 + 4 * e) * L::kLdv + cv +
                                   j * 8 + t4 * 2) =
            make_float2(dva[j * 4 + e], dva[j * 4 + e + 1]);
    }
  }

  // the cluster's sum, rank by rank: block `rank` adds and writes rows
  // [rank per, (rank + 1) per) of the tile
  __syncwarp();
  hopper::cluster_arrive(true);
  hopper::cluster_wait();
  {
    const int per = (L::kKeys + c - 1) / c;
    const int lo = rank * per, n = min(L::kKeys, lo + per) - lo;
    const float* part = reinterpret_cast<const float*>(smem);
    float* dkb = dk + b * dk_sb + kh * dk_sh;
    float* dvb = dv + b * dv_sb + kh * dv_sh;
    constexpr int kVecK = D / 4, kVecV = DV / 4;  // float4 per row
    for (int i = tid; i < n * (kVecK + kVecV); i += kThreads) {
      // dK's rows first, then dV's
      const int which = i >= n * kVecK, j = which ? i - n * kVecK : i;
      const int vec = which ? kVecV : kVecK, r = lo + j / vec,
                col = (j % vec) * 4;
      const int off = which ? L::kKeys * L::kLdk + r * L::kLdv + col
                            : r * L::kLdk + col;
      // every rank's load in flight at once, then the sum in rank order
      float4 x[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < c)
          x[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, q) + off);
      float4 a = x[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q) {
        if (q < c) {
          a.x += x[q].x;
          a.y += x[q].y;
          a.z += x[q].z;
          a.w += x[q].w;
        }
      }
      const int key = k0 + r;
      if (key < Skv)
        *reinterpret_cast<float4*>(
            (which ? dvb + key * dv_ss : dkb + key * dk_ss) + col) = a;
    }
  }
  // the other blocks' shared memory outlives their readers
  hopper::cluster_arrive(false);
  hopper::cluster_wait();
}

bool bad_shape(int B, int H, int KH, int Sq, int Skv) {
  return B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
         (long long)B * H > 0x7fffffffLL;
}

// The four operands' maps, each a main and a tail map (q, k at width D; v,
// dO at DV); false if TMA cannot describe a layout.
bool make_maps(CUtensorMap* m, int* axes, const void* q, const void* k,
               const void* v, const void* go, int D, int DV, int B, int H,
               int KH, int Sq, int Skv, const long long* qs,
               const long long* ks, const long long* vs, const long long* gs,
               int q_rows, int kv_rows, bool narrow_q = false) {
  axes[0] = flash::map_operand(&m[0], &m[1], q, D, Sq, H, B, qs[2], qs[1],
                               qs[0], q_rows);
  if (narrow_q && axes[0] >= 0 &&  // q's tail map: 32-column boxes
      flash::map_bshd(&m[1], q, D, Sq, H, B, qs[2], qs[1], qs[0], q_rows,
                      32) != axes[0])
    axes[0] = -1;
  axes[1] = flash::map_operand(&m[2], &m[3], k, D, Skv, KH, B, ks[2], ks[1],
                               ks[0], kv_rows);
  axes[2] = flash::map_operand(&m[4], &m[5], v, DV, Skv, KH, B, vs[2],
                               vs[1], vs[0], kv_rows);
  axes[3] = flash::map_operand(&m[6], &m[7], go, DV, Sq, H, B, gs[2], gs[1],
                               gs[0], q_rows);
  return axes[0] >= 0 && axes[1] >= 0 && axes[2] >= 0 && axes[3] >= 0;
}

template <int D, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* go,
              const void* m, const void* l, const void* di, const void* qpos,
              const void* kpos, void* dq, int B, int H, int KH, int Sq,
              int Skv, const long long* qs, const long long* ks,
              const long long* vs, const long long* gs, long long dq_sb,
              long long dq_sh, long long dq_ss, int has_window, int window,
              int q_tiles, int heads_per_block, int smem, void* stream) {
  if (bad_shape(B, H, KH, Sq, Skv) || heads_per_block < 1 ||
      (H / KH) % heads_per_block ||
      q_tiles != (Sq + kDqRows - 1) / kDqRows || q_tiles > 65535 ||
      smem != DqSmem<D, DV>::bytes((Skv + kDqKeys - 1) / kDqKeys) ||
      smem > 232448 || (dq_sb | dq_sh | dq_ss) & 1 ||
      reinterpret_cast<uintptr_t>(dq) & 7)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  int axes[4];
  if (!make_maps(maps, axes, q, k, v, go, D, DV, B, H, KH, Sq, Skv, qs, ks,
                 vs, gs, kDqRows, kDqKeys))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * (H / heads_per_block), q_tiles);
  flash_bwd_dq_kernel<D, DV><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      axes[0], axes[1], axes[2], axes[3],
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(di), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(dq), H, KH, Sq, Skv,
      dq_sb, dq_sh, dq_ss, has_window, window, heads_per_block);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* go,
               const void* m, const void* l, const void* di,
               const void* qpos, const void* kpos, void* dk, void* dv, int B,
               int H, int KH, int Sq, int Skv, const long long* qs,
               const long long* ks, const long long* vs, const long long* gs,
               long long dk_sb, long long dk_sh, long long dk_ss,
               long long dv_sb, long long dv_sh, long long dv_ss,
               int has_window, int window, int kv_tiles, int cluster,
               int smem, void* stream) {
  if (bad_shape(B, H, KH, Sq, Skv) || cluster < 1 ||
      cluster > kMaxCluster || (H / KH) % cluster ||
      (long long)cluster * KH * B > 0x7fffffffLL ||
      kv_tiles != (Skv + DkvSmem<D, DV>::kKeys - 1) / DkvSmem<D, DV>::kKeys ||
      kv_tiles > 65535 ||
      smem != DkvSmem<D, DV>::bytes((Sq + kDkvRows - 1) / kDkvRows) ||
      smem > 232448 || (dk_sb | dk_sh | dk_ss | dv_sb | dv_sh | dv_ss) & 3 ||
      (reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
          15)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  int axes[4];
  if (!make_maps(maps, axes, q, k, v, go, D, DV, B, H, KH, Sq, Skv, qs, ks,
                 vs, gs, kDkvRows, DkvSmem<D, DV>::kKeys,
                 DkvSmem<D, DV>::kSplit))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * KH * B, kv_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, flash_bwd_dkv_kernel<D, DV>, maps[0], maps[1], maps[2], maps[3],
      maps[4], maps[5], maps[6], maps[7], axes[0], axes[1], axes[2], axes[3],
      static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(di),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<float*>(dk), static_cast<float*>(dv), H, KH, Sq, Skv, dk_sb,
      dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, has_window, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K2.  q (B, H, Sq, D), k (B, KH, Skv, D), v (B, KH, Skv, DV), go (B, H,
// Sq, DV) bf16 given by pointer and element strides (batch, head,
// sequence; the last axis is contiguous, strides multiples of 8, bases
// 16-byte aligned), (D, DV) = (hd, dv), one of (64, 64), (128, 128),
// (96, 64), (192, 128), (80, 80); m / l / di (B, H, Sq) fp32 contiguous;
// qpos (Sq,), kpos (Skv,) int32; dq (B, H, Sq, D) fp32 by strides
// (multiples of 2, base 8-byte aligned).  The plan
// (attention_ops.py::flash_bwd_plan): q_tiles = ceil(Sq / 128) grid rows of
// B H / heads_per_block blocks, each sweeping heads_per_block heads of one
// GQA group (a divisor of G), `smem` bytes of dynamic shared memory.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a width, shape,
// layout or plan the kernel does not take.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* go,
    const void* m, const void* l, const void* di, const void* qpos,
    const void* kpos, void* dq, int B, int H, int KH, int Sq, int Skv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long go_sb, long long go_sh, long long go_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, int has_window,
    int window, int q_tiles, int heads_per_block, int smem, int hd, int dv,
    void* stream) {
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss}, gs[3] = {go_sb, go_sh, go_ss};
  auto run = [&](auto fn) {
    return fn(q, k, v, go, m, l, di, qpos, kpos, dq, B, H, KH, Sq, Skv, qs,
              ks, vs, gs, dq_sb, dq_sh, dq_ss, has_window, window, q_tiles,
              heads_per_block, smem, stream);
  };
  if (hd == 64 && dv == 64) return run(launch_dq<64, 64>);
  if (hd == 128 && dv == 128) return run(launch_dq<128, 128>);
  if (hd == 96 && dv == 64) return run(launch_dq<96, 64>);
  if (hd == 192 && dv == 128) return run(launch_dq<192, 128>);
  if (hd == 80 && dv == 80) return run(launch_dq<80, 80>);
  return (int)cudaErrorInvalidValue;
}

// K3.  Operands as K2; dk (B, KH, Skv, D) and dv (B, KH, Skv, DV) fp32 by
// strides (multiples of 4, bases 16-byte aligned), each the sum over the
// G = H / KH query heads of the group.  The plan: kv_tiles = ceil(Skv /
// 128) (64 at (192, 128)) grid rows of cluster KH B blocks in clusters of
// `cluster` (a divisor of G, at most 8), `smem` bytes of dynamic shared
// memory.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* go,
    const void* m, const void* l, const void* di, const void* qpos,
    const void* kpos, void* dk, void* dv, int B, int H, int KH, int Sq,
    int Skv, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long go_sb, long long go_sh, long long go_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, int has_window, int window,
    int kv_tiles, int cluster, int smem, int hd, int dvw, void* stream) {
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss}, gs[3] = {go_sb, go_sh, go_ss};
  auto run = [&](auto fn) {
    return fn(q, k, v, go, m, l, di, qpos, kpos, dk, dv, B, H, KH, Sq, Skv,
              qs, ks, vs, gs, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
              has_window, window, kv_tiles, cluster, smem, stream);
  };
  if (hd == 64 && dvw == 64) return run(launch_dkv<64, 64>);
  if (hd == 128 && dvw == 128) return run(launch_dkv<128, 128>);
  if (hd == 96 && dvw == 64) return run(launch_dkv<96, 64>);
  if (hd == 192 && dvw == 128) return run(launch_dkv<192, 128>);
  if (hd == 80 && dvw == 80) return run(launch_dkv<80, 80>);
  return (int)cudaErrorInvalidValue;
}
