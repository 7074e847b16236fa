// RD-FSQ wire kernels K4 (quantize + pack) and K5 (unpack + dequantize).
//
// Replaces src/repro/kernels/rdfsq_kernel.py::quantize_pallas (K4) and
// ::dequantize_pallas (K5), the Pallas kernels behind the 2-bit split wire.
//
// Bound on the H100: bytes.  K4 reads each activation once (2 B in bf16)
// and writes bits/8 B of codes; K5 reads the codes and writes 2 B.  There
// is no reuse, so the only lever is to touch each byte once with as few
// instructions as the load/store units allow.  The per-row (lo, hi) come
// from the stats pass that runs outside the kernel (as in the reference).
// Both kernels read bf16 directly instead of the fp32 copy the reference
// makes (the cast is exact), and read the ragged end of a row as zeros,
// which is what the reference's zero-padded columns hold, so no padded
// copy is made.
//
// Two paths, chosen by the wrapper from shapes and addresses alone
// (kernels/ops.py::rdfsq_path):
//
// - vector: the dense rows start 16-byte aligned and the word rows 8-byte
//   aligned.  Every global access is 16 bytes of values or 8 bytes of
//   words a thread, and every warp-wide access covers contiguous bytes:
//   a warp reads (K4) or writes (K5) its 32 groups of 8 word bytes' values
//   as 16-byte chunks, lane l taking chunks l, l + 32, ..., and the words
//   pass through 256 B of shared memory a warp, where lane l stores (K4)
//   or loads (K5) its own group's 8 bytes with one 8-byte access.  K4
//   issues all of a thread's loads first (at 2 bits in bf16, four 16-byte
//   loads for one 8-byte store); K5 one 8-byte load for four 16-byte
//   stores.  A block covers a run of one row's words, the grid strides
//   over those runs from the SM count, and every per-row constant is made
//   once a block by extra prologue warps while the data warps' loads are
//   in flight; the data warps wait for it on an mbarrier (a block barrier
//   would wait for their loads as well):
//   * K4 at 1 and 2 bits finds the row's 2^bits - 1 code thresholds (the
//     least float whose code reaches k), one prologue warp each, by a
//     32-way search over the ordered float bit patterns in [lo, hi] with
//     the code's own op sequence, starting from a narrow bracket around
//     the real-arithmetic threshold that the first round verifies.  Every
//     step from x to the code is monotone under round-to-nearest, so an
//     element's code is the number of thresholds at or below it: no
//     division per element, and NaN (which compares false) still gives
//     code 0, as fmaxf(NaN, lo) does.  bf16 values compare two at a time
//     against the thresholds rounded up to bf16 (exact for bf16 values).
//     At 4 and 8 bits the 15 or 255 thresholds would cost more than they
//     save, and each element takes the op sequence itself.
//   * K5's prologue warp computes the row's 2^bits outputs and expands
//     them into a 256-entry table in shared memory that maps a word byte
//     to its 8 / bits outputs; a 16-byte chunk of outputs costs one to
//     eight table reads, no division.
//   A row's ragged end reads zeros past C (K4) and writes nothing past C
//   (K5).
// - scalar: the general case (any alignment, e.g. 3 x 1001 fp32): one
//   thread per packed byte over a 2-D grid (words of a row, rows), the op
//   sequence per element.
//
// Numerics follow the plain PyTorch version operation by operation:
// every step is an explicitly rounded intrinsic so that nvcc cannot fuse a
// multiply and an add into an FMA, and the round is rintf (half to even, as
// torch.round and jnp.round), never roundf (half away from zero).  The
// codes are then bit-identical to the plain version's, on both paths.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
// vector path: 8-byte groups of words a thread owns
constexpr int kGroups = 1;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// scalar path
// ---------------------------------------------------------------------------

// 2^bits levels are always even: the grid is round(half*e - 0.5) + 0.5,
// clipped to +-half (rdfsq_kernel.py:44-48).
template <typename T, int SB>
__global__ void __launch_bounds__(kThreads)
    rdfsq_quantize_scalar(const T* __restrict__ x,
                          const float* __restrict__ stats,
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
    rdfsq_dequantize_scalar(const uint8_t* __restrict__ words,
                            const float* __restrict__ stats,
                            T* __restrict__ out, int64_t C, int64_t CW,
                            float half) {
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

// ---------------------------------------------------------------------------
// vector path
// ---------------------------------------------------------------------------

// K4's op sequence for one value, as in the scalar kernel.
__device__ __forceinline__ unsigned int fsq_code(float v, float lo, float hi,
                                                 float den, float half) {
  const float c = fminf(fmaxf(v, lo), hi);
  const float q = __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(c, lo)), den);
  float z = __fadd_rn(
      rintf(__fsub_rn(__fmul_rn(half, __fsub_rn(q, 1.0f)), 0.5f)), 0.5f);
  z = fminf(fmaxf(z, -half), half);
  return (unsigned int)__fadd_rn(z, half);
}

// Float bit patterns as ints in the floats' order (-0 just below +0).
__device__ __forceinline__ int float_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The least float t (in key order) with code(t) >= k, or NaN when even
// code(hi) < k.  code(lo) is 0 < k, so t lies in (lo, hi].  Called by a
// whole warp.  The first round tests 32 keys over a narrow bracket around
// the real-arithmetic threshold lo + (k - 1/2) den / (2^bits - 1), lane 0
// its low end and lane 31 its high end; the bracket is kept if the code
// is below k at the one and reaches k at the other, else the search
// starts again from [lo, hi] (after checking code(hi) >= k).  Each
// further round tests 32 evenly spaced keys of (L, H], lane 31 H itself,
// and the ballot keeps the interval between the last key that fails and
// the first that holds: n keys shrink to ceil(n / 32).
__device__ float code_threshold(unsigned int k, float lo, float hi,
                                float den, float half, int lane) {
  const float est = lo + ((float)k - 0.5f) * den / (2.0f * half);
  const float d = 0x1p-21f * (den + fabsf(lo) + fabsf(est));
  long long L = float_key(fmaxf(est - d, lo));
  long long H = float_key(fminf(est + d, hi));
  {
    const long long n = H - L;
    const long long p = lane == 31 ? H : L + ((n * lane) >> 5);
    const unsigned int m = __ballot_sync(
        0xffffffffu, fsq_code(key_float((int)p), lo, hi, den, half) >= k);
    if (n > 0 && !(m & 1u) && (m >> 31)) {
      const int f = __ffs(m) - 1;
      if (f < 31) H = L + ((n * f) >> 5);
      L += (n * (f - 1)) >> 5;
    } else {
      if (fsq_code(hi, lo, hi, den, half) < k)
        return __int_as_float(0x7fffffff);
      L = float_key(lo);
      H = float_key(hi);
    }
  }
  while (H - L > 1) {
    const long long n = H - L;
    const long long p = L + ((n * (lane + 1)) >> 5);
    const bool holds = fsq_code(key_float((int)p), lo, hi, den, half) >= k;
    const int f = __ffs(__ballot_sync(0xffffffffu, holds)) - 1;
    H = L + ((n * (f + 1)) >> 5);
    if (f > 0) L += (n * f) >> 5;
  }
  return key_float((int)H);
}

__device__ __forceinline__ unsigned int lane_word(const uint4& u, int q) {
  return q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned int u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// Value i of a 16-byte chunk of T.
template <typename T>
__device__ __forceinline__ float chunk_value(const uint4& v, int i) {
  if constexpr (sizeof(T) == 2) {
    const unsigned int w = lane_word(v, i / 2);
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  } else {
    return __uint_as_float(lane_word(v, i));
  }
}

__device__ __forceinline__ unsigned int raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned int raw_bits(float v) {
  return __float_as_uint(v);
}

// The codes of a chunk of 8 bf16 values at 1 or 2 bits, two values a
// compare: for a bf16 x, x >= t exactly when x >= the least bf16 >= t
// (T, in both halves of the pair; NaN stays NaN and compares false).  At
// 2 bits the code's bits are b1 = [x >= t2] and b0 = [x >= t1] xor
// [x >= t2] xor [x >= t3], since t1 <= t2 <= t3.  Value i's code lands at
// bits i * bits of the result.
template <int SB>
__device__ __forceinline__ unsigned int bf16_chunk_codes(
    const uint4& v, unsigned int T1, unsigned int T2, unsigned int T3) {
  unsigned int z = 0;  // value 2p's code at p * 2 * SB, 2p + 1's 16 above
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __nv_bfloat162 w = as_bf162(lane_word(v, p));
    const unsigned int m1 = __hge2_mask(w, as_bf162(T1));
    if constexpr (SB == 1) {
      z |= (m1 & 0x00010001u) << (2 * p);
    } else {
      const unsigned int m2 = __hge2_mask(w, as_bf162(T2));
      const unsigned int m3 = __hge2_mask(w, as_bf162(T3));
      z |= (((m1 ^ m2 ^ m3) & 0x00010001u) | (m2 & 0x00020002u)) << (4 * p);
    }
  }
  return SB == 1 ? (z | z >> 15) & 0xffu : (z | z >> 14) & 0xffffu;
}

// A threshold as a bf16 pair, rounded up (see bf16_chunk_codes).
__device__ __forceinline__ unsigned int bf16_pair_up(float t) {
  const unsigned int b = __bfloat16_as_ushort(__float2bfloat16_ru(t));
  return b | b << 16;
}

__device__ __forceinline__ void store16(void* p, const unsigned int (&o)[4]) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
               : "memory");
}

// A 16-byte load that stays where it is written: issued before the
// block's prologue, so that the bytes are in flight while it runs.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p)
               : "memory");
  return r;
}
__device__ __forceinline__ uint2 load8(const void* p) {
  uint2 r;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p)
               : "memory");
  return r;
}

// The vector path's layout.  A block has B data threads (64 - 256) and
// kPrologueWarps<SB>() warps more that make the row's constants (K4's
// thresholds, K5's table) and publish them through an mbarrier, so that
// the data threads wait for those alone: a __syncthreads between a
// thread's loads and their use would wait for the loads too.  The data
// threads own a run of B * kGroups groups of 8 word bytes of one row (a
// tile); data warp w's part of sub-tile g is the 32 groups gb + g B +
// [32 w, 32 w + 32): 256 B of words and 32 * 8 * per values.  Its values
// are read, and written, as 16-byte chunks, chunk c of the part by lane
// c % 32, so that every warp-wide access covers 512 contiguous bytes; the
// words pass through 256 B of shared memory a warp, where lane l reads or
// writes its group's 8 bytes at 8 l.  Chunk c holds the codes at bits
// [c CB, (c + 1) CB) of the part, CB = 16 / sizeof(T) * bits (4 - 64).

// Prologue warps of a block: K4's thresholds at 1 and 2 bits, one warp
// each; K5's table, one warp.
template <int SB>
__host__ __device__ constexpr int quantize_prologue_warps() {
  return SB <= 2 ? (1 << SB) - 1 : 0;
}
constexpr int kDequantizePrologueWarps = 1;

template <typename T, int SB>
__global__ void __launch_bounds__(kThreads + 96)
    rdfsq_quantize_vector(const T* __restrict__ x,
                          const float* __restrict__ stats,
                          uint8_t* __restrict__ words, int64_t C, int64_t CW,
                          int64_t tiles_per_row, int64_t n_tiles, float half) {
  constexpr int PER = 8 / SB;           // codes a byte
  constexpr int CODES = 8 * PER;        // codes a group
  constexpr int VEC = 16 / sizeof(T);   // values a chunk
  constexpr int LOADS = CODES / VEC;    // chunks a group: loads a thread
  constexpr int CB = VEC * SB;          // code bits a chunk
  constexpr int PAIR = 4 / sizeof(T);   // values a 32-bit lane of a chunk
  constexpr int NTHR = quantize_prologue_warps<SB>();  // thresholds
  __shared__ float thr[3];
  __shared__ __align__(8) uint64_t published;
  __shared__ __align__(16) uint8_t staged[kThreads / 32][kGroups][256];
  const int64_t gpr = CW / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x - 32 * NTHR;  // data threads
  if constexpr (NTHR > 0) {
    if (threadIdx.x == 0) hopper::mbar_init(&published, 32 * NTHR);
    __syncthreads();
  }
  int64_t cached_row = -1;
  uint32_t phase = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row = tile / tiles_per_row;
    const bool new_row = row != cached_row;
    if (threadIdx.x >= nthreads) {  // a prologue warp: threshold k
      if (new_row) {
        const float lo = stats[2 * row], hi = stats[2 * row + 1];
        const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-6f);
        const int k = warp - nthreads / 32;
        const float t = code_threshold(k + 1, lo, hi, den, half, lane);
        if (lane == 0) thr[k] = t;
        __syncwarp();
        hopper::mbar_arrive(&published);
      }
    } else {
      const int64_t gb =
          (tile % tiles_per_row) * nthreads * kGroups + 32 * warp;
      const T* xr = x + row * C;
      uint4 v[kGroups][LOADS];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int64_t col =
              (gb + g * nthreads) * CODES + (int64_t)(32 * j + lane) * VEC;
          if (col + VEC <= C) {
            v[g][j] = load16(xr + col);
          } else {  // the row's ragged end: zeros past C
            unsigned int q[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              q[m] = 0;
#pragma unroll
              for (int h = 0; h < PAIR; ++h) {
                const int64_t c = col + m * PAIR + h;
                if (c < C) q[m] |= raw_bits(xr[c]) << (16 * h);
              }
            }
            v[g][j] = make_uint4(q[0], q[1], q[2], q[3]);
          }
        }
      }
      // after the loads: a use of the stats would wait for them first
      const float lo = stats[2 * row], hi = stats[2 * row + 1];
      const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-6f);
      float t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
      if constexpr (NTHR > 0) {
        if (new_row) hopper::mbar_wait(&published, phase);
        t1 = thr[0];
        if constexpr (NTHR == 3) {
          t2 = thr[1];
          t3 = thr[2];
        }
      }
      const unsigned int T1 = bf16_pair_up(t1), T2 = bf16_pair_up(t2),
                         T3 = bf16_pair_up(t3);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        uint8_t* part = staged[warp][g];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int c = 32 * j + lane;
          unsigned int bits[2] = {0u, 0u};  // CB bits, the first 32 in [0]
          if constexpr (NTHR > 0 && sizeof(T) == 2) {
            bits[0] = bf16_chunk_codes<SB>(v[g][j], T1, T2, T3);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float f = chunk_value<T>(v[g][j], i);
              unsigned int code;
              if constexpr (NTHR > 0) {
                code = f >= t1;
                if constexpr (NTHR == 3) code += (f >= t2) + (f >= t3);
              } else {
                code = fsq_code(f, lo, hi, den, half);
              }
              bits[i * SB / 32] |= code << (i * SB % 32);
            }
          }
          if constexpr (CB == 64) {
            reinterpret_cast<uint2*>(part)[c] = make_uint2(bits[0], bits[1]);
          } else if constexpr (CB == 32) {
            reinterpret_cast<unsigned int*>(part)[c] = bits[0];
          } else if constexpr (CB == 16) {
            reinterpret_cast<unsigned short*>(part)[c] =
                (unsigned short)bits[0];
          } else if constexpr (CB == 8) {
            part[c] = (uint8_t)bits[0];
          } else {  // a nibble: lane pairs share a byte
            const unsigned int next =
                __shfl_down_sync(0xffffffffu, bits[0], 1);
            if (lane % 2 == 0) part[c / 2] = (uint8_t)(bits[0] | next << 4);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int64_t gi = gb + g * nthreads + lane;
        if (gi < gpr)
          reinterpret_cast<uint2*>(words + row * CW)[gi] =
              reinterpret_cast<const uint2*>(staged[warp][g])[lane];
      }
    }
    if (new_row) phase ^= 1u;
    cached_row = row;
    // the thresholds and parts are read before the next tile's
    if (tile + gridDim.x < n_tiles) __syncthreads();
  }
}

template <typename T, int SB>
__global__ void __launch_bounds__(kThreads + 32)
    rdfsq_dequantize_vector(const uint8_t* __restrict__ words,
                            const float* __restrict__ stats,
                            T* __restrict__ out, int64_t C, int64_t CW,
                            int64_t tiles_per_row, int64_t n_tiles,
                            float half) {
  constexpr int PER = 8 / SB;
  constexpr int CODES = 8 * PER;
  constexpr int LEVELS = 1 << SB;
  constexpr unsigned int MASK = LEVELS - 1u;
  constexpr int VEC = 16 / sizeof(T);    // outputs a chunk
  constexpr int STORES = CODES / VEC;    // chunks a group: stores a thread
  constexpr int CB = VEC * SB;           // code bits a chunk
  constexpr int EB = PER * sizeof(T);    // bytes of a table entry
  constexpr int EW = EB >= 4 ? EB / 4 : 1;  // its 32-bit words
  constexpr int PAIR = 4 / sizeof(T);
  __shared__ unsigned int level[LEVELS];  // the row's outputs, raw bits
  __shared__ __align__(16) unsigned int table[256 * EW];
  __shared__ __align__(8) uint64_t published;
  __shared__ __align__(16) uint8_t staged[kThreads / 32][kGroups][256];
  const int64_t gpr = CW / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x - 32 * kDequantizePrologueWarps;
  if (threadIdx.x == 0) hopper::mbar_init(&published, 32);
  __syncthreads();
  int64_t cached_row = -1;
  uint32_t phase = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row = tile / tiles_per_row;
    const bool new_row = row != cached_row;
    if (threadIdx.x >= nthreads) {  // the prologue warp: the row's table
      if (new_row) {
        const float lo = stats[2 * row], hi = stats[2 * row + 1];
        const float span = __fsub_rn(hi, lo);
        for (int i = lane; i < LEVELS; i += 32) {
          const float code = (float)i;
          const float c = __fdiv_rn(__fsub_rn(code, half), half);
          const float val = __fadd_rn(
              __fmul_rn(__fdiv_rn(__fadd_rn(c, 1.0f), 2.0f), span), lo);
          T t;
          store_f32(&t, val);
          level[i] = raw_bits(t);
        }
        __syncwarp();
        // entry b: the outputs of byte b's codes, code i at byte i * size
        for (int b = lane; b < 256; b += 32) {
          if constexpr (EB == 2) {
            reinterpret_cast<unsigned short*>(table)[b] =
                (unsigned short)level[b];
          } else {
#pragma unroll
            for (int q = 0; q < EW; ++q) {
              unsigned int e = 0;
#pragma unroll
              for (int h = 0; h < PAIR; ++h) {
                const int i = q * PAIR + h;
                e |= level[(b >> (i * SB)) & MASK] << (16 * h);
              }
              table[b * EW + q] = e;
            }
          }
        }
        __syncwarp();
        hopper::mbar_arrive(&published);
      }
    } else {
      const int64_t gb =
          (tile % tiles_per_row) * nthreads * kGroups + 32 * warp;
      uint2 w[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int64_t gi = gb + g * nthreads + lane;
        w[g] = gi < gpr ? load8(words + row * CW + 8 * gi) : make_uint2(0, 0);
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        reinterpret_cast<uint2*>(staged[warp][g])[lane] = w[g];
      __syncwarp();
      if (new_row) hopper::mbar_wait(&published, phase);
      T* orow = out + row * C;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint8_t* part = staged[warp][g];
#pragma unroll
        for (int j = 0; j < STORES; ++j) {
          const int c = 32 * j + lane;
          const int64_t col = (gb + g * nthreads) * CODES + (int64_t)c * VEC;
          if (col >= C) continue;
          unsigned int bits[2] = {0u, 0u};  // CB bits, the first 32 in [0]
          if constexpr (CB == 64) {
            const uint2 b = reinterpret_cast<const uint2*>(part)[c];
            bits[0] = b.x;
            bits[1] = b.y;
          } else if constexpr (CB == 32) {
            bits[0] = reinterpret_cast<const unsigned int*>(part)[c];
          } else if constexpr (CB == 16) {
            bits[0] = reinterpret_cast<const unsigned short*>(part)[c];
          } else if constexpr (CB == 8) {
            bits[0] = part[c];
          } else {  // a nibble
            bits[0] = (part[c / 2] >> (4 * (c % 2))) & 0xfu;
          }
          if (col + VEC <= C) {
            unsigned int o[4];
            if constexpr (EB == 2) {  // 8 bytes of one output each
#pragma unroll
              for (int b = 0; b < 8; ++b) {
                const unsigned int h = reinterpret_cast<const unsigned short*>(
                    table)[(bits[b / 4] >> (8 * (b % 4))) & 0xffu];
                if (b % 2 == 0) o[b / 2] = h;
                else o[b / 2] |= h << 16;
              }
            } else if constexpr (EB == 4) {  // 4 bytes
#pragma unroll
              for (int b = 0; b < 4; ++b)
                o[b] = table[(bits[0] >> (8 * b)) & 0xffu];
            } else if constexpr (EB == 8) {  // 2 bytes
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const uint2 e = reinterpret_cast<const uint2*>(
                    table)[(bits[0] >> (8 * b)) & 0xffu];
                o[2 * b] = e.x;
                o[2 * b + 1] = e.y;
              }
            } else {  // one byte, or a nibble: an entry's first 16 bytes
              const uint4 e =
                  reinterpret_cast<const uint4*>(table)[bits[0] * (EB / 16)];
              o[0] = e.x;
              o[1] = e.y;
              o[2] = e.z;
              o[3] = e.w;
            }
            store16(orow + col, o);
          } else {  // the row's ragged end: nothing past C
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const unsigned int v =
                  level[(bits[i * SB / 32] >> (i * SB % 32)) & MASK];
              if (col + i < C) {
                if constexpr (sizeof(T) == 2)
                  reinterpret_cast<unsigned short*>(orow)[col + i] =
                      (unsigned short)v;
                else
                  reinterpret_cast<unsigned int*>(orow)[col + i] = v;
              }
            }
          }
        }
      }
    }
    if (new_row) phase ^= 1u;
    cached_row = row;
    // the table and parts are read before the next tile's
    if (tile + gridDim.x < n_tiles) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = n;
  return n;
}

// The vector path's grid: tiles of B * kGroups groups of one row, B the
// largest block of 64 - 256 threads that still gives every SM a tile,
// strided over by at most one full wave of blocks.
struct VectorGrid {
  int64_t tiles_per_row, n_tiles;
  unsigned int blocks, threads;
};

VectorGrid vector_grid(int64_t R, int64_t CW) {
  const int64_t sms = sm_count();
  VectorGrid g;
  g.threads = kThreads;
  for (;;) {
    const int64_t per_tile = (int64_t)g.threads * kGroups;
    g.tiles_per_row = (CW / 8 + per_tile - 1) / per_tile;
    g.n_tiles = R * g.tiles_per_row;
    if (g.threads == 64 || g.n_tiles >= sms) break;
    g.threads /= 2;
  }
  const int64_t wave = sms * (2048 / g.threads);
  g.blocks = (unsigned int)(g.n_tiles < wave ? g.n_tiles : wave);
  return g;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int SB>
int launch_quantize(const void* x, const float* stats, uint8_t* words,
                    int64_t R, int64_t C, bool vector, cudaStream_t stream) {
  constexpr int PER = 8 / SB;
  const int64_t CW = (C + PER - 1) / PER;
  const float half = ((1 << SB) - 1) / 2.0f;
  if (vector) {
    if (CW % 8 || (C * (int64_t)sizeof(T)) % 16 || !aligned(x, 16) ||
        !aligned(words, 8))
      return (int)cudaErrorMisalignedAddress;
    const VectorGrid g = vector_grid(R, CW);
    if (g.blocks == 0) return (int)cudaSuccess;
    rdfsq_quantize_vector<T, SB>
        <<<g.blocks, g.threads + 32 * quantize_prologue_warps<SB>(), 0,
           stream>>>(
        static_cast<const T*>(x), stats, words, C, CW, g.tiles_per_row,
        g.n_tiles, half);
  } else {
    dim3 grid((unsigned)((CW + kThreads - 1) / kThreads), (unsigned)R);
    rdfsq_quantize_scalar<T, SB><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), stats, words, C, CW, half);
  }
  return (int)cudaGetLastError();
}

template <typename T, int SB>
int launch_dequantize(const uint8_t* words, const float* stats, void* out,
                      int64_t R, int64_t C, bool vector,
                      cudaStream_t stream) {
  constexpr int PER = 8 / SB;
  const int64_t CW = (C + PER - 1) / PER;
  const float half = ((1 << SB) - 1) / 2.0f;
  if (vector) {
    if (CW % 8 || (C * (int64_t)sizeof(T)) % 16 || !aligned(out, 16) ||
        !aligned(words, 8))
      return (int)cudaErrorMisalignedAddress;
    const VectorGrid g = vector_grid(R, CW);
    if (g.blocks == 0) return (int)cudaSuccess;
    rdfsq_dequantize_vector<T, SB>
        <<<g.blocks, g.threads + 32 * kDequantizePrologueWarps, 0,
           stream>>>(
        words, stats, static_cast<T*>(out), C, CW, g.tiles_per_row,
        g.n_tiles, half);
  } else {
    dim3 grid((unsigned)((CW + kThreads - 1) / kThreads), (unsigned)R);
    rdfsq_dequantize_scalar<T, SB><<<grid, kThreads, 0, stream>>>(
        words, stats, static_cast<T*>(out), C, CW, half);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_quantize(const void* x, const float* stats, uint8_t* words,
                      int64_t R, int64_t C, int bits, bool vector,
                      cudaStream_t s) {
  switch (bits) {
    case 1: return launch_quantize<T, 1>(x, stats, words, R, C, vector, s);
    case 2: return launch_quantize<T, 2>(x, stats, words, R, C, vector, s);
    case 4: return launch_quantize<T, 4>(x, stats, words, R, C, vector, s);
    case 8: return launch_quantize<T, 8>(x, stats, words, R, C, vector, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dequantize(const uint8_t* words, const float* stats, void* out,
                        int64_t R, int64_t C, int bits, bool vector,
                        cudaStream_t s) {
  switch (bits) {
    case 1: return launch_dequantize<T, 1>(words, stats, out, R, C, vector, s);
    case 2: return launch_dequantize<T, 2>(words, stats, out, R, C, vector, s);
    case 4: return launch_dequantize<T, 4>(words, stats, out, R, C, vector, s);
    case 8: return launch_dequantize<T, 8>(words, stats, out, R, C, vector, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (R, C) bf16 or fp32 row-major; stats (R, 2) fp32 (lo, hi); words
// (R, ceil(C / (8 / bits))) uint8; vector: 1 for the vector path (the
// wrapper's rdfsq_path), which refuses misaligned operands.  Returns
// cudaGetLastError() or the refusal.
extern "C" int rdfsq_quantize(const void* x, int x_is_bf16, const void* stats,
                              void* words, long long R, long long C, int bits,
                              int vector, void* stream) {
  const float* st = static_cast<const float*>(stats);
  uint8_t* w = static_cast<uint8_t*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? dispatch_quantize<__nv_bfloat16>(x, st, w, R, C, bits,
                                                      vector != 0, s)
                   : dispatch_quantize<float>(x, st, w, R, C, bits,
                                              vector != 0, s);
}

// words (R, ceil(C / (8 / bits))) uint8; stats (R, 2) fp32 (the payload's
// fp16 values); out (R, C) bf16 or fp32; vector as for rdfsq_quantize.
extern "C" int rdfsq_dequantize(const void* words, const void* stats,
                                void* out, int out_is_bf16, long long R,
                                long long C, int bits, int vector,
                                void* stream) {
  const uint8_t* w = static_cast<const uint8_t*>(words);
  const float* st = static_cast<const float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16
             ? dispatch_dequantize<__nv_bfloat16>(w, st, out, R, C, bits,
                                                  vector != 0, s)
             : dispatch_dequantize<float>(w, st, out, R, C, bits,
                                          vector != 0, s);
}
