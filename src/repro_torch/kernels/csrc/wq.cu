// Fused packed dequant + matmul of the weight-only quantized serve path,
// K12: out (M, N) = x (M, K) @ w (K, N), with w stored as int2/3/4 codes
// and w = code * scale + min dequantized on the fly.
//
// Replaces src/repro/kernels/wq_kernel.py::matmul_pallas (the Pallas kernel
// behind every w* matmul site of the block stacks under repro.wq).
//
// Rounding, in every variant as in the plain version: code * scale + min in
// fp32 as a rounded product and a rounded sum (no contraction into one
// FMA), the weight rounded to the activation dtype, products of bf16
// operands exact in fp32.  The code becomes the float 2^23 + code through
// its bits (the integer-to-float unit runs at an eighth of the FP32 rate),
// and one FFMA (2^23 + code) s - 2^23 s gives code * s exactly, which is
// the rounded product, since a code of at most 4 bits times an fp16 scale
// is exact in fp32.  Only the fp32 order of summation differs from the
// plain version; the bf16 variants round the fp32 sum once to bf16 (what
// `.to(bfloat16)` of the fp32 result gives).
//
// Bound on the H100.  At a decode tick (M 4) bytes: the packed weights and
// their fp16 scales / mins, bits/16 + 2/group of the bf16 weight's bytes
// (2.4 MB at the w_gate site, 0.72 us).  At prefill (M 1 024 - 4 096) the
// bf16 operations (36 GFLOP at M 4 096 on w_gate, 36.6 us).  Two variants
// behind one wrapper (kernels/wq_ops.py picks by M and shape):
//
// * wq_gemv_kernel, M <= 16 (ticks, generate steps; also any shape the
//   TMA variant cannot map).  A cluster of up to 8 blocks covers 32
//   columns and 16 rows of x, each block a slice of K, so that the small
//   store of a tick spreads over many SMs (each SM holds few loads in
//   flight).  A block first stages its slice of the store and of x's rows
//   in shared memory with every load in flight at once; the act-order
//   gather is folded into that load of x (x[:, perm[k]]).  Its 4 warps
//   split the slice: per k16 step a warp runs 4 mma.sync m16n8k16 with x's
//   rows (zero past M) as A and the dequantized weights, built in
//   registers, as B, so the CUDA cores only dequantize.  The warps' sums,
//   then the blocks' sums (through distributed shared memory), are added
//   in a fixed order: the same bits on every run, one launch, no atomics.
//   What is left: a fixed cost per launch (staging, two cluster
//   barriers) above cuBLAS's on the dense weight.
// * wq_wgmma_kernel, M > 16 with K % 64 == 0 and N % 16 == 0 (prefill).
//   The product is computed transposed, out^T = w^T x^T: the dequantized
//   weights are wgmma's A operand, built in registers with no trip through
//   shared memory, and x is B, read by wgmma straight from the stage TMA
//   wrote.  A block of two warpgroups covers 128 output columns (an m64
//   tile each) and BT = 256, 128 or 64 rows of x (one, two or two blocks
//   per SM; wq_ops.py::wgmma_tokens).  Thread 0 keeps a ring of kStages
//   stages filled by TMA (the x tile with 128-byte swizzle, the tile's
//   packed words, scales and mins), one mbarrier per stage; each warpgroup
//   builds tile i + 1's A while tile i's 4 wgmma m64nBTk16 run and issues
//   them as soon as tile i retires.  The act-order gather of x
//   stays in the wrapper here (one index_select per call next to a 36
//   GFLOP product).  What is left: building a tile's A takes a large
//   share of the tensor cores' time for it, and the two do not fully
//   overlap: under half of the card's bf16 rate at M 4 096.
//
// The fp32-activation kernel (wq_matmul_f32_kernel) is a simple tile
// kernel: one block per 64 x 64 output tile, FFMA, no TF32; it is not on
// the bf16 serve path.
//
// Not yet: warp specialisation (a producer warp, setmaxnreg), a
// persistent tile scheduler, a TMA store of the output tile, multicast of
// the x tile across a cluster.
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

struct Packed {
  const uint8_t* words;  // (PK, N) uint8
  const __half* scales;  // (G, N) fp16
  const __half* mins;    // (G, N) fp16
  int K, N, PK, bits, group;
};

// code * s + m as the plain version rounds it (fmul, then fadd), with
// ns = -2^23 s.  The code (< 2^23) becomes the float 2^23 + code through
// its bits, with no integer-to-float conversion (an eighth of the FP32
// rate); one FFMA then gives (2^23 + code) s - 2^23 s = code s exactly,
// since code (<= 4 bits) times the fp16 scale (11 bits) is exact in fp32,
// so it equals fmul(code, s).
__device__ __forceinline__ float dq(uint32_t code, float s, float ns,
                                    float m) {
  const float f = __uint_as_float(0x4B000000u | code);
  return __fadd_rn(__fmaf_rn(f, s, ns), m);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------ small M: split-K GEMV ---

constexpr int kGemvWarps = 4, kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 32, kGemvRows = 16, kGemvMaxSplits = 8;

struct GemvSmem {  // byte offsets into the kernel's dynamic shared memory
  int words, scales, mins, x, red, total, ldx, g_rows;
  // one K slice of sps k16 steps (whole octets), rows rows of x
  __host__ __device__ GemvSmem(int sps, int bits, int group, int rows) {
    g_rows = (sps * 16 + group - 1) / group + 1;  // scale-group rows touched
    ldx = sps * 16 + 8;  // bf16; +8 spreads the rows over banks
    words = 0;
    scales = words + sps * 2 * bits * kGemvCols;
    mins = scales + g_rows * kGemvCols * 2;
    x = mins + g_rows * kGemvCols * 2;
    red = x + (rows * ldx * 2 + 15) / 16 * 16;
    total = red + kGemvWarps * kGemvRows * kGemvCols * 4;
  }
};

// Copies `rows` rows of `bytes` (a multiple of 16, at most 64) from a
// row-major global array (row stride `ld` bytes, `n_rows` rows, `row_bytes`
// per row) starting at (row r0, byte column c0) into a dense smem tile;
// what lies past the array's edge reads 0.  16-byte loads where the layout
// allows, all in flight together.
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint8_t* src,
                                           long long ld, int r0, int c0,
                                           int rows, int bytes, int n_rows,
                                           int row_bytes, bool vec, int tid) {
  const int chunks = bytes / 16;
  for (int i = tid; i < rows * chunks; i += kGemvThreads) {
    const int r = i / chunks, c = (i % chunks) * 16;
    const uint8_t* g = src + (long long)(r0 + r) * ld + c0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) {
      if (vec && c0 + c + 16 <= row_bytes) {
        v = __ldg(reinterpret_cast<const uint4*>(g));
      } else {
        __align__(16) uint8_t b[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) b[j] = c0 + c + j < row_bytes ? g[j] : 0;
        v = *reinterpret_cast<const uint4*>(b);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * bytes + c) = v;
  }
}

__device__ __forceinline__ float half_at(uint2 h, int c) {
  const uint32_t w = c < 2 ? h.x : h.y;
  return __half2float(
      __ushort_as_half((unsigned short)(w >> (16 * (c & 1)))));
}

// A cluster of `splits` (1 - 8) blocks covers columns [n0, n0 + 32) and
// rows [m0, m0 + 16) of x; block rank ks takes the K slice of k16 steps
// [ks sps, (ks + 1) sps).  A block first stages its slice of the store and
// of x's rows (gathered through perm for an act-order store, zero past M
// and K) in shared memory, every load in flight at once.  Its 4 warps split the
// slice: per k16 step 4 mma.sync m16n8k16, x as A and the dequantized
// weights, built in registers, as B; in product c lane (g, t) supplies
// column 4 g + c, so its code bytes of 4 neighbouring columns are one
// 32-bit read.  The warps' sums are added in warp order; then block 0 of
// the cluster adds the slices' sums in rank order through distributed
// shared memory and writes bf16.
template <int BITS>
__global__ void __launch_bounds__(kGemvThreads)
    wq_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                       const int* __restrict__ perm, Packed p,
                       __nv_bfloat16* __restrict__ out, int M, int sps,
                       int spw) {
  extern __shared__ __align__(16) uint8_t smem_g[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, N = p.N;
  const int m0 = blockIdx.y * kGemvRows, rows = min(kGemvRows, M - m0);
  const GemvSmem L(sps, BITS, p.group, rows);
  const int ks = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const int n0 = (blockIdx.x / splits) * kGemvCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = ks * sps * 16;  // this slice's first k
  const int groups = (K + p.group - 1) / p.group, g0 = k_begin / p.group;

  const bool vw = (N & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(p.words) & 15u) == 0u;
  const bool vs = (N & 7) == 0 &&
                  (reinterpret_cast<uintptr_t>(p.scales) & 15u) == 0u &&
                  (reinterpret_cast<uintptr_t>(p.mins) & 15u) == 0u;
  stage_tile(smem_g + L.words, p.words, N, k_begin / 8 * BITS, n0,
             sps * 2 * BITS, kGemvCols, p.PK, N, vw, tid);
  stage_tile(smem_g + L.scales, reinterpret_cast<const uint8_t*>(p.scales),
             2ll * N, g0, 2 * n0, L.g_rows, 2 * kGemvCols, groups, 2 * N, vs,
             tid);
  stage_tile(smem_g + L.mins, reinterpret_cast<const uint8_t*>(p.mins),
             2ll * N, g0, 2 * n0, L.g_rows, 2 * kGemvCols, groups, 2 * N, vs,
             tid);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_g + L.x);
  for (int i = tid; i < rows * (L.ldx - 8); i += kGemvThreads) {
    const int r = i / (L.ldx - 8), kl = i % (L.ldx - 8), k = k_begin + kl;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (k < K) v = x[(long long)(m0 + r) * K + (perm != nullptr ? perm[k] : k)];
    x_s[r * L.ldx + kl] = v;
  }
  __syncthreads();

  constexpr uint32_t mask = (1u << BITS) - 1u;
  // codes 2 t, 2 t + 1 of an octet: bits 2 t BITS .. of its word, from
  // byte-row r_lo (and r_hi where they straddle a byte)
  const int b0 = 2 * t * BITS, r_lo = b0 >> 3, sh = b0 & 7;
  const int r_hi = min(r_lo + 1, BITS - 1);
  const bool two = sh + 2 * BITS > 8;
  const uint8_t* w_s = smem_g + L.words + 4 * g;
  const uint8_t* s_s = smem_g + L.scales + 8 * g;
  const uint8_t* m_s = smem_g + L.mins + 8 * g;
  float acc[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const int s_end = min((warp + 1) * spw, sps);
  for (int st = warp * spw; st < s_end; ++st) {
    const int kl = st * 16, k = k_begin + kl;
    uint32_t a[4];
    a[0] = g < rows ? flash::ld32(x_s + g * L.ldx + kl + 2 * t) : 0u;
    a[1] = g + 8 < rows ? flash::ld32(x_s + (g + 8) * L.ldx + kl + 2 * t) : 0u;
    a[2] = g < rows ? flash::ld32(x_s + g * L.ldx + kl + 8 + 2 * t) : 0u;
    a[3] = g + 8 < rows ? flash::ld32(x_s + (g + 8) * L.ldx + kl + 8 + 2 * t)
                        : 0u;
    uint32_t lo[2], hi[2];
    uint2 sc[2], mn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 2 * st + h, gi = (k + 8 * h) / p.group - g0;
      lo[h] = *reinterpret_cast<const uint32_t*>(
          w_s + (o * BITS + r_lo) * kGemvCols);
      hi[h] = two ? *reinterpret_cast<const uint32_t*>(
                        w_s + (o * BITS + r_hi) * kGemvCols)
                  : 0u;
      sc[h] = *reinterpret_cast<const uint2*>(s_s + gi * 2 * kGemvCols);
      mn[h] = *reinterpret_cast<const uint2*>(m_s + gi * 2 * kGemvCols);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = (((lo[h] >> (8 * c)) & 0xFFu) |
                            (((hi[h] >> (8 * c)) & 0xFFu) << 8)) >> sh;
        const float s = half_at(sc[h], c), m = half_at(mn[h], c);
        const float ns = -8388608.0f * s;
        const int kc = k + 8 * h + 2 * t;  // this pair's first k
        const float w0 = kc < K ? dq(v & mask, s, ns, m) : 0.0f;
        const float w1 = kc + 1 < K ? dq((v >> BITS) & mask, s, ns, m) : 0.0f;
        b[h] = pack_bf16(w0, w1);
      }
      flash::mma_16816(acc[c], a, b[0], b[1]);
    }
  }

  // acc[c][e]: row g (e < 2) or g + 8, column 8 t + 4 (e & 1) + c; the
  // block's sum goes to the first warp's slot
  float* red = reinterpret_cast<float*>(smem_g + L.red);
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * kGemvRows + g + 8 * (e >> 1)) * kGemvCols + 8 * t +
          4 * (e & 1) + c] = acc[c][e];
  __syncthreads();
  for (int i = tid; i < rows * kGemvCols; i += kGemvThreads) {
    float v = red[i];
#pragma unroll
    for (int w = 1; w < kGemvWarps; ++w)
      v += red[w * kGemvRows * kGemvCols + i];
    red[i] = v;
  }
  hopper::cluster_arrive(true);
  hopper::cluster_wait();
  if (ks == 0) {
    for (int i = tid; i < rows * kGemvCols; i += kGemvThreads) {
      const int r = i / kGemvCols, c = i % kGemvCols;
      float v = 0.0f;
      for (int q = 0; q < splits; ++q)
        v += cluster.map_shared_rank(red, q)[i];
      if (n0 + c < N)
        out[(long long)(m0 + r) * N + n0 + c] = __float2bfloat16_rn(v);
    }
  }
  // the other blocks' shared memory outlives block 0's reads
  hopper::cluster_arrive(false);
  hopper::cluster_wait();
}

// ------------------------------------------------- large M: TMA + wgmma ---
//
// out^T = w^T x^T: the dequantized weights are wgmma's A operand, built in
// registers, and x is B, read from shared memory as TMA wrote it.  A block
// of two warpgroups covers 128 output columns (an m64 tile each) and BT
// rows of x.  Row r of a warpgroup's m64 tile is output
// column 16 (r / 16) + 2 (r % 8) + (r % 16) / 8 of the tile, so a thread's
// two rows (g and g + 8) are two neighbouring columns: one 16-bit read
// gives both columns' code byte, and one 32-bit store writes both outputs.

constexpr int kBK = 64, kStages = 5, kWgThreads = 256, kWgCols = 128;

__host__ __device__ constexpr int up(int v, int a) {
  return (v + a - 1) / a * a;
}

struct WgLayout {  // byte offsets into the 1 024-aligned dynamic smem
  int x, words, scales, mins, bars, total, x_b, words_b, scal_b;
  __host__ __device__ WgLayout(int bn, int bt, int bits, int rows) {
    x_b = bt * kBK * 2;
    words_b = up(bn * 8 * bits, 128);
    scal_b = up(bn * rows * 2, 128);
    x = 0;
    words = x + kStages * x_b;
    scales = words + kStages * words_b;
    mins = scales + kStages * scal_b;
    bars = mins + kStages * scal_b;
    total = bars + kStages * 8;
  }
};

template <int BT>
__device__ __forceinline__ void wgmma_rs(float (&d)[BT / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BT == 256) hopper::wgmma_m64n256_rs(d, a, db, 1);
  else if constexpr (BT == 128) hopper::wgmma_m64n128_rs(d, a, db, 1);
  else hopper::wgmma_m64n64_rs<0>(d, a, db, 1);
}

// The A fragments of one k tile (64 k, 4 k16 steps) for this thread's two
// columns c, c + 1, dequantized from one stage.  In k16 step kk a thread
// holds k = 16 kk + 2 t + {0, 1} (from octet 2 kk) and 16 kk + 8 + 2 t +
// {0, 1} (octet 2 kk + 1): codes 2 t and 2 t + 1 of two octets, bits
// 2 t BITS .. 2 t BITS + 2 BITS - 1 of the octet word.
template <int BITS, bool ONE_GROUP>
__device__ __forceinline__ void build_a(uint32_t (&a)[4][4],
                                        const uint8_t* wsm,
                                        const __half* ssm, const __half* msm,
                                        int cols, int c, int t, int k0,
                                        int group) {
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int b0 = 2 * t * BITS, r_lo = b0 >> 3, sh = b0 & 7;
  const int r_hi = min(r_lo + 1, BITS - 1);
  const bool two = sh + 2 * BITS > 8;
  // the octets' scale-group rows, counted from the tile's first group
  // without a division per octet (group is a multiple of 8); a group that
  // is a multiple of 64 gives the whole tile one row
  int gi_of[8];
  if constexpr (ONE_GROUP) {
#pragma unroll
    for (int o = 0; o < 8; ++o) gi_of[o] = 0;
  } else {
    int gi = 0, next = (k0 / group + 1) * group - k0;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      if (o * 8 >= next) {
        ++gi;
        next += group;
      }
      gi_of[o] = gi;
    }
  }
  float s0 = 0.f, s1 = 0.f, m0 = 0.f, m1 = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int gi = gi_of[o];  // uniform
    if (o == 0 || (!ONE_GROUP && gi != gi_of[o > 0 ? o - 1 : 0])) {
      const __half2 s2 = *reinterpret_cast<const __half2*>(ssm + gi * cols + c);
      const __half2 m2 = *reinterpret_cast<const __half2*>(msm + gi * cols + c);
      s0 = __low2float(s2);
      s1 = __high2float(s2);
      m0 = __low2float(m2);
      m1 = __high2float(m2);
      n0 = -8388608.0f * s0;  // exact: s is an fp16 value
      n1 = -8388608.0f * s1;
    }
    const uint8_t* row = wsm + (o * BITS) * cols + c;
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(row + r_lo * cols);
    const uint32_t hi =
        two ? *reinterpret_cast<const uint16_t*>(row + r_hi * cols) : 0u;
    // bits of columns c (v0) and c + 1 (v1) from byte-row r_lo upwards
    const uint32_t v0 = ((lo & 0xFFu) | ((hi & 0xFFu) << 8)) >> sh;
    const uint32_t v1 = ((lo >> 8) | (hi & 0xFF00u)) >> sh;
    // row g: column c, row g + 8: column c + 1; octet 2 kk -> a[kk][0, 1],
    // octet 2 kk + 1 -> a[kk][2, 3]
    const int kk = o >> 1, half = (o & 1) * 2;
    a[kk][half] = pack_bf16(dq(v0 & mask, s0, n0, m0),
                            dq((v0 >> BITS) & mask, s0, n0, m0));
    a[kk][half + 1] = pack_bf16(dq(v1 & mask, s1, n1, m1),
                                dq((v1 >> BITS) & mask, s1, n1, m1));
  }
}

template <int BT, int BITS, bool ONE_GROUP>
__global__ void __launch_bounds__(kWgThreads, BT == 256 ? 1 : 2)
    wq_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap mmap,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int group, int rows) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1 024-aligned for the 128-byte swizzle; offset from smem_raw so that
  // the compiler still reads through it with shared-memory loads
  uint8_t* smem = smem_raw + ((1024u - hopper::smem_u32(smem_raw)) & 1023u);
  const WgLayout L(kWgCols, BT, BITS, rows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = wt % 32, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kWgCols, m0 = blockIdx.y * BT;
  const int nk = K / kBK;
  const int c = wg * 64 + warp * 16 + 2 * g;  // this thread's columns
  const uint32_t stage_tx =
      L.x_b + kWgCols * 8 * BITS + 2 * kWgCols * rows * 2;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int i) {
    const int s = i % kStages;
    hopper::mbar_expect_tx(&bars[s], stage_tx);
    hopper::tma_load_2d(smem + L.x + s * L.x_b, &xmap, &bars[s], i * kBK, m0);
    hopper::tma_load_2d(smem + L.words + s * L.words_b, &wmap, &bars[s], n0,
                        i * 8 * BITS);
    hopper::tma_load_2d(smem + L.scales + s * L.scal_b, &smap, &bars[s], n0,
                        i * kBK / group);
    hopper::tma_load_2d(smem + L.mins + s * L.scal_b, &mmap, &bars[s], n0,
                        i * kBK / group);
  };
  auto build = [&](uint32_t (&a)[4][4], int i) {
    const int s = i % kStages;
    hopper::mbar_wait(&bars[s], (i / kStages) & 1);
    build_a<BITS, ONE_GROUP>(
        a, smem + L.words + s * L.words_b,
        reinterpret_cast<const __half*>(smem + L.scales + s * L.scal_b),
        reinterpret_cast<const __half*>(smem + L.mins + s * L.scal_b),
        kWgCols, c, t, i * kBK, group);
  };
  if (tid == 0)
    for (int i = 0; i < min(kStages, nk); ++i) issue(i);

  float acc[BT / 2];
#pragma unroll
  for (int j = 0; j < BT / 2; ++j) acc[j] = 0.0f;
  uint32_t a0[4][4], a1[4][4];

  // k tile i's products run while the threads build tile i + 1's A; each
  // warpgroup issues tile i + 1's products as soon as its own tile i
  // retires, then the block syncs (every warpgroup is past tile i, so its
  // stage goes back to TMA) while the tensor cores work
  auto issue_mma = [&](uint32_t (&a)[4][4], int i) {
    const uint64_t db =
        hopper::desc_sw128(smem + L.x + (i % kStages) * L.x_b);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<BT>(acc, a[kk], db + 2 * kk);
    hopper::wgmma_commit();
  };
  auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int i) {
    if (i + 1 < nk) build(nxt, i + 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::keep_regs(cur[kk]);
    if (i + 1 < nk) issue_mma(nxt, i + 1);
    __syncthreads();
    if (tid == 0 && i + kStages < nk) issue(i + kStages);
  };

  build(a0, 0);
  issue_mma(a0, 0);
  for (int i = 0; i < nk; i += 2) {
    step(a0, a1, i);
    if (i + 1 < nk) step(a1, a0, i + 1);
  }

  // accumulator element 4 j + e: A row g (column c) for e < 2, g + 8
  // (column c + 1) otherwise; token 8 j + 2 t + (e & 1)
  const int col = n0 + c;
  if (col >= N) return;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * t + e;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (long long)row * N + col) =
            pack_bf16(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
  }
}

// ------------------------------------------- fp32 activations (simple) ---

constexpr int kFBM = 64, kFBN = 64, kFBK = 64, kFThreads = 128;

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
  for (int j = 0; j < 8; ++j)
    w[j] = k + j < p.K ? dq((word >> (j * p.bits)) & mask, s, -8388608.0f * s,
                            m)
                       : 0.0f;
}

// each thread owns 4 rows x 8 columns (columns tx + 8 j)
__global__ void __launch_bounds__(kFThreads)
    wq_matmul_f32_kernel(const float* __restrict__ x, Packed p,
                         float* __restrict__ out, int M) {
  __shared__ float x_s[kFBM][kFBK + 1];
  __shared__ float w_s[kFBK][kFBN];  // [k][n]

  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int K = p.K, N = p.N;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    __syncthreads();
    for (int i = tid; i < kFBM * kFBK; i += kFThreads) {
      const int r = i / kFBK, c = i % kFBK;
      const int row = m0 + r, k = k0 + c;
      x_s[r][c] = row < M && k < K ? x[(long long)row * K + k] : 0.0f;
    }
    for (int i = tid; i < kFBN * (kFBK / 8); i += kFThreads) {
      const int c = i % kFBN, o = i / kFBN;
      float w[8];
      dequant_octet(p, k0 / 8 + o, n0 + c, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) w_s[o * 8 + j][c] = w[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFBK; ++k) {
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

Packed make_packed(const void* words, const void* scales, const void* mins,
                   int K, int N, int bits, int group) {
  return Packed{static_cast<const uint8_t*>(words),
                static_cast<const __half*>(scales),
                static_cast<const __half*>(mins), K, N, (K * bits + 7) / 8,
                bits, group};
}

template <int BITS>
cudaError_t launch_gemv(dim3 grid, int splits, size_t smem, cudaStream_t st,
                        const __nv_bfloat16* x, const int* perm, Packed p,
                        __nv_bfloat16* out, int M, int sps, int spw) {
  cudaError_t err = cudaFuncSetAttribute(
      wq_gemv_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wq_gemv_kernel<BITS>, x, perm, p, out, M,
                            sps, spw);
}

template <int BT, int BITS, bool ONE_GROUP>
cudaError_t launch_wgmma(const void* x, const void* words, const void* scales,
                         const void* mins, void* out, int M, int K, int N,
                         int group, cudaStream_t st) {
  constexpr int BN = kWgCols;
  const int G = (K + group - 1) / group, PK = K * BITS / 8;
  const int rows = min(G, 63 / group + 2);
  CUtensorMap xm, wm, sm, mm;
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M}, xs[1] = {2ull * K};
  const uint32_t xb[2] = {kBK, BT};
  const uint64_t wd[2] = {(uint64_t)N, (uint64_t)PK}, wst[1] = {(uint64_t)N};
  const uint32_t wbx[2] = {BN, 8 * BITS};
  const uint64_t sd[2] = {(uint64_t)N, (uint64_t)G}, ss[1] = {2ull * N};
  const uint32_t sb[2] = {BN, (uint32_t)rows};
  if (!hopper::make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs,
                        xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, words, wd, wst,
                        wbx, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, scales, sd,
                        ss, sb, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map(&mm, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, mins, sd, ss,
                        sb, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int smem = WgLayout(BN, BT, BITS, rows).total + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wq_wgmma_kernel<BT, BITS, ONE_GROUP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BT - 1) / BT);
  wq_wgmma_kernel<BT, BITS, ONE_GROUP><<<grid, kWgThreads, smem, st>>>(
      xm, wm, sm, mm, static_cast<__nv_bfloat16*>(out), M, K, N, group,
      rows);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_wgmma_bits(const void* x, const void* words,
                              const void* scales, const void* mins, void* out,
                              int M, int K, int N, int bits, int group,
                              cudaStream_t st) {
  const bool one = group % kBK == 0;
#define WQ_LAUNCH(B)                                                         \
  return one ? launch_wgmma<BT, B, true>(x, words, scales, mins, out, M, K, \
                                         N, group, st)                       \
             : launch_wgmma<BT, B, false>(x, words, scales, mins, out, M, K, \
                                          N, group, st)
  switch (bits) {
    case 2:
      WQ_LAUNCH(2);
    case 3:
      WQ_LAUNCH(3);
    default:
      WQ_LAUNCH(4);
  }
#undef WQ_LAUNCH
}

}  // namespace

// All operands contiguous: x (M, K) bf16; words (PK = ceil(K bits / 8), N)
// uint8; scales / mins (ceil(K / group), N) fp16; out (M, N) bf16.  bits in
// 2..4, group a positive multiple of 8.  Each returns cudaGetLastError().
//
// GEMV: perm (K,) int32 storage-order gather of x's columns or null; the
// grid is (splits ceil(N / 32), ceil(M / 16)) in clusters of `splits`
// (1 - 8) blocks along K, each block a slice of sps k16 steps (splits sps
// >= ceil(K / 16)), each of its 4 warps spw of them (4 spw >= sps;
// wq_ops.py::gemv_plan).  A block's slice
// of the store and of x's rows and the warps' sums must fit the 227 KB of
// shared memory (wq_ops.py::gemv_smem_bytes).
extern "C" int wq_matmul_bf16_gemv(const void* x, const void* perm,
                                   const void* words, const void* scales,
                                   const void* mins, void* out, int M, int K,
                                   int N, int bits, int group, int splits,
                                   int sps, int spw, void* stream) {
  const int rows = M < kGemvRows ? M : kGemvRows;
  const size_t smem = GemvSmem(sps, bits, group, rows).total;
  if (splits < 1 || splits > kGemvMaxSplits || sps <= 0 || spw <= 0 ||
      splits * sps < (K + 15) / 16 || kGemvWarps * spw < sps || bits < 2 ||
      bits > 4 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Packed p = make_packed(words, scales, mins, K, N, bits, group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kGemvCols - 1) / kGemvCols * splits,
                  (M + kGemvRows - 1) / kGemvRows);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pi = static_cast<const int*>(perm);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (bits == 2)
    err = launch_gemv<2>(grid, splits, smem, st, xb, pi, p, o, M, sps, spw);
  else if (bits == 3)
    err = launch_gemv<3>(grid, splits, smem, st, xb, pi, p, o, M, sps, spw);
  else
    err = launch_gemv<4>(grid, splits, smem, st, xb, pi, p, o, M, sps, spw);
  return (int)err;
}

// TMA + wgmma: K % 64 == 0, N % 16 == 0, x, words, scales and mins 16-byte
// aligned; 128 columns x `tokens` (256, 128 or 64) rows of x per block
// (wq_ops.py::wgmma_tokens picks).
extern "C" int wq_matmul_bf16_wgmma(const void* x, const void* words,
                                    const void* scales, const void* mins,
                                    void* out, int M, int K, int N, int bits,
                                    int group, int tokens, void* stream) {
  if (K % kBK || N % 16 || bits < 2 || bits > 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tokens == 256)
    err = launch_wgmma_bits<256>(x, words, scales, mins, out, M, K, N, bits,
                                 group, st);
  else if (tokens == 128)
    err = launch_wgmma_bits<128>(x, words, scales, mins, out, M, K, N, bits,
                                 group, st);
  else if (tokens == 64)
    err = launch_wgmma_bits<64>(x, words, scales, mins, out, M, K, N, bits,
                                group, st);
  return (int)err;
}

// fp32 activations, out (M, N) fp32; M at most 65 535 * 64.
extern "C" int wq_matmul_f32(const void* x, const void* words,
                             const void* scales, const void* mins, void* out,
                             int M, int K, int N, int bits, int group,
                             void* stream) {
  const Packed p = make_packed(words, scales, mins, K, N, bits, group);
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
  wq_matmul_f32_kernel<<<grid, kFThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), p, static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}
