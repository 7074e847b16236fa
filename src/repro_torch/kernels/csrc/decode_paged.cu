// Single-token GQA decode attention, all four decode kernels on one body:
// K6 (ring cache, bf16), K7 (ring cache, int8 codes with fp16 absmax
// scales), K8 (paged pools, bf16) and K9 (paged pools, int8 with fp16 scale
// pools).
//
// Replaces src/repro/kernels/decode_kernel.py::decode (K6), ::decode_q8
// (K7), ::decode_paged (K8) and ::decode_paged_q8 (K9), the Pallas kernels
// behind every step of the static generate loop over ring caches and every
// decode tick of the serving engine over paged pools.  The TPU kernels
// sweep a row's cache (ring blocks, or pages through the table row) in
// order on one core, carrying (m, l, acc) in VMEM across a sequential grid
// axis.
//
// One kernel, templated on where a row's keys lie (the address source):
//
// * TablePages (K8 / K9): page j of a slot is entry e = page_table[slot,
//   j] of the (P, pg, KH, D) pools (-1: unallocated), its key t the flat
//   token e pg + t, its position pos_pool[e pg + t].
// * RingPages (K6 / K7): row b of a (B, L, KH, D) ring cache is
//   ceil(L / pg) virtual pages of pg keys; key t of page j is the flat
//   token b L + j pg + t, present while j pg + t < L (the last page is
//   ragged, so any L is taken), its position kpos[b L + j pg + t].  No
//   table is read.  Which keys are visible is decided by the positions
//   alone, never by slot order, so a wrapped ring needs nothing more.
//
// Both sources keep the scales of an int8 cache at the flat token x KH +
// kh, where the cache keeps them; the reference's wrappers first make
// (N, KH, T) fp32 transposed copies.
//
// The head width D (q / k and v alike) is a template parameter, 64
// (tinyllava), 128 (llama3_2_3b) or 80 (zamba2_2_7b); the entry points
// dispatch on it.  A row is D / 64 column blocks of 64, and every per-row
// step below (the fragment loads, the k-steps of S, the n-tiles of O, the
// partials) runs once a block, so D 64 compiles to the code of a single
// block.  At D 80 a tail block of 16 columns follows the full one: one more
// k-step of S, whose fragments are 4 contiguous elements of a Q and a K row
// (permuted alike), and two more n-tiles of O, n-tile t holding the
// columns 64 + 2 j + t, so that a thread reads one bf16 pair (int8: two
// codes) of each of its V rows.  A bf16 row of 80 (160 B, 10 chunks) would
// put rows r and r + 4 on the same banks, and the chunk swizzle of a full
// block (ch ^ (row & 7)) would carry the tail's two chunks past the row, so
// bf16 rows of 80 are padded to 88 elements (176 B, 11 chunks) and kept
// unswizzled: with an odd count of chunks between rows, the 8 threads of
// a quarter warp hit 8 distinct 16-byte bank groups in the full block's K
// and V reads, and a warp's 4-byte tail V reads hit 32 distinct banks; the
// 8-byte tail K reads meet one 2-way conflict a half warp (rows 0 and 3).
// int8 rows of 80 stay 80 B, their full-block K reads 2-way conflicted as
// at 128.
//
// Bound on the H100: bytes, and at the serve and generate shapes (4 rows of
// some 800 keys, 5 kv heads) mostly latency.  Each cache byte read feeds
// about 4 flops (G = 4 query heads per kv head), far below the ~295
// flop/byte of the bf16 tensor cores; a call moves 1 - 4 MB, about a
// microsecond at 3.35 TB/s, so what sets its time is how many memory
// latencies lie one after another.  The design cuts that chain:
//
// * Split-L over a thread-block cluster.  One cluster of C blocks (a
//   power of two, at most 8) per (row, kv head); rank r takes pages
//   [r ppr, (r + 1) ppr) of the row.  C and ppr come from
//   attention_ops.decode_paged_plan: the fewest ranks that put a block on
//   every SM (C = 8, 160 blocks, 8 pages a rank at the serve shape; 7
//   virtual pages of 16 keys a rank at the generate shape, L 825).
// * All of a rank's loads in flight at once.  A rank reads its keys'
//   positions in one pass (after its table entries, for K8 / K9), lists the
//   pages that hold a visible key (unallocated pages, pages past qpos and
//   pages outside the window are never read), then issues 16-byte cp.async
//   copies of every listed page's K and V rows into shared memory (rows of
//   keys that are not visible, or past a ragged ring row's end, are
//   zero-filled, not read) and waits once.  The listed pages go in rounds
//   of `rnd` pages, 32 KB of K and V at most (the whole rank at the serve
//   and generate shapes); with more than one round the next round's copies
//   fly while this one is computed (two buffers).  K7 / K9's fp16 scales
//   come with plain loads beside them.
// * Products on the tensor cores: mma.sync m16n8k16, S = Q K^T with the
//   query heads as the 16 rows (G <= 16; rows past G are zero) and 8 keys
//   a column tile, then O += P V with P taken straight from S's
//   accumulators (the flash-attention-2 register layout).  The head
//   dimension is permuted alike in Q and K so that each thread reads 16
//   contiguous elements of a K row; O's columns are permuted so that each
//   thread reads one 16-byte chunk of a V row.  bf16 rows are stored with
//   their 16-byte chunks swizzled by the row, so neither read conflicts.
//   int8 codes convert to bf16 exactly in registers.  The rounding is the
//   reference's: s = (q . k) [x k_scale] in fp32, l sums the unscaled p,
//   p [x v_scale] is rounded to bf16 before the PV product.
// * Each warp of a block takes every fourth 16-key chunk of a round and
//   keeps its own (m, l, acc); the four warps' partials combine in warp
//   order, then the cluster's ranks combine theirs in rank order through
//   distributed shared memory, each rank writing a disjoint slice of the
//   (G, D) output once.  No atomics, no second kernel: the same bits on
//   every run, one launch per call.  A rank with no visible key holds
//   m = -1e30, l = 0, acc = 0 and adds exactly 0; a row with no visible
//   key (qpos = -1, or every key outside the window) returns exactly 0, as
//   the reference's Pallas decode kernels and paged references do.
//
// What is left (scripts/decode_paged_variants.py times the parts, for the
// paged serve shape and the ring generate shape): the positions -> K / V
// chain (table -> positions -> K / V for K8 / K9) is still two (three)
// dependent memory latencies, then the products, then two cluster barriers
// around the combine.  On an H100 SXM at 700 W, of K8's 0.0106 ms at the
// serve shape an empty cluster launch took 0.0015, the copies about 0.004,
// the products and softmax about 0.0015 and the combine through
// distributed shared memory about 0.001; halving the cluster cost 0.0035
// ms or more.
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;  // query heads per kv head: one m16 tile
constexpr int kMaxPage = 64;
constexpr int kMaxCluster = 8;
constexpr int kSmemMax = 232448;
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// The elements a K or V row takes in shared memory: D, but bf16 rows of 80
// padded to 88 (see above).
__host__ __device__ constexpr int row_ld(int D, int elem) {
  return elem == 2 && D % 64 ? D + 8 : D;
}

// Byte offsets of a block's dynamic shared memory at head width D (mirrored
// by attention_ops.decode_paged_plan, which the entry points check):
//   kv     `nbuf` round buffers of K then V rows (kr rows of row_ld(D)
//          elements);
//          after the sweep the warps' partials (m, l of 16 rows, acc of G
//          rows) reuse it
//   rv     per buffer, one visibility byte per row
//   sc     (K9) per buffer, the rows' K then V scales in fp32
//   entry  the rank's page entries (table entries, or ring page indices);
//          list: its visible pages, in order;
//   pv     a flag per page: holds a visible key; vis: a flag per key
//   part   the block's partial (m, l of 16 rows, acc of G rows), which the
//          cluster's ranks read
//   misc   the count of visible pages
struct Layout {
  int kr, kv, rv, sc, entry, list, pv, vis, part, misc, bytes;
  __host__ __device__ Layout(int D, int elem, bool scaled, int G, int pg,
                             int ppr, int rnd, int nbuf) {
    kr = round16(rnd * pg);
    const int kv_bytes = nbuf * 2 * kr * row_ld(D, elem) * elem;
    const int warp_part = kWarps * (2 * kMaxG + G * D) * 4;
    int at = 0;
    kv = at;
    at += round16(kv_bytes > warp_part ? kv_bytes : warp_part);
    rv = at;
    at += round16(nbuf * kr);
    sc = at;
    at += scaled ? nbuf * kr * 2 * 4 : 0;
    entry = at;
    at += round16(ppr * 4);
    list = at;
    at += round16(ppr * 4);
    pv = at;
    at += round16(ppr);
    vis = at;
    at += round16(ppr * pg);
    part = at;
    at += (2 * kMaxG + G * D) * 4;
    misc = at;
    at += 16;
    bytes = at;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element type traits at head width D: the row stride in shared memory,
// 16-byte chunks per row, where chunk `ch` of row `row` lies (bf16 rows of
// whole blocks swizzle each column block's 8 chunks by the row), the
// fragments each thread reads from column block cb (the elements
// [64 cb, 64 cb + 64) of a row) and from the 16-column tail at 64 (D / 64).
template <typename Elem, int D>
struct Rows;

template <int D>
struct Rows<__nv_bfloat16, D> {
  static constexpr int kLd = row_ld(D, 2);
  static constexpr int kChunks = D / 8;
  static constexpr int kT = D / 64 * 64;  // the tail's first element
  __device__ __forceinline__ static int chunk(int row, int ch) {
    return D % 64 ? ch : ch ^ (row & 7);
  }
  // S's B fragments: elements 64 cb + [16 q4, 16 q4 + 16) of a K row, as
  // pairs
  __device__ __forceinline__ static void k_frag(const __nv_bfloat16* k,
                                                int row, int cb, int q4,
                                                uint32_t b[8]) {
    const __nv_bfloat16* r = k + row * kLd;
    const uint4 lo = *reinterpret_cast<const uint4*>(
        r + chunk(row, 8 * cb + 2 * q4) * 8);
    const uint4 hi = *reinterpret_cast<const uint4*>(
        r + chunk(row, 8 * cb + 2 * q4 + 1) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = word(lo, i);
      b[4 + i] = word(hi, i);
    }
  }
  // PV's B fragments of O column tile nt of block cb (O column d = 64 cb +
  // 8 g4 + nt): the elements 64 cb + [8 g4, 8 g4 + 8) of V rows r0, r0 + 1,
  // r0 + 8, r0 + 9
  struct VFrag {
    uint4 v[4];
  };
  __device__ __forceinline__ static VFrag v_frag(const __nv_bfloat16* v,
                                                 int r0, int cb, int g4) {
    VFrag f;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f.v[i] = *reinterpret_cast<const uint4*>(
          v + rows[i] * kLd + chunk(rows[i], 8 * cb + g4) * 8);
    return f;
  }
  __device__ __forceinline__ static void v_b(const VFrag& f, int nt,
                                             uint32_t& b0, uint32_t& b1) {
    const int sel = (nt & 1) ? 0x7632 : 0x5410;
    b0 = __byte_perm(word(f.v[0], nt >> 1), word(f.v[1], nt >> 1), sel);
    b1 = __byte_perm(word(f.v[2], nt >> 1), word(f.v[3], nt >> 1), sel);
  }
  // the tail's k-step of S: elements kT + 4 q4 + (0, 1 | 2, 3) of a K row
  __device__ __forceinline__ static void k_tail(const __nv_bfloat16* k,
                                                int row, int q4,
                                                uint32_t b[2]) {
    const uint2 w =
        *reinterpret_cast<const uint2*>(k + row * kLd + kT + 4 * q4);
    b[0] = w.x;
    b[1] = w.y;
  }
  // the tail's n-tiles of O (n-tile t: columns kT + 2 j + t): the pair
  // kT + 2 g4 + (0, 1) of V rows r0, r0 + 1, r0 + 8, r0 + 9
  struct VTail {
    uint32_t v[4];
  };
  __device__ __forceinline__ static VTail v_tail(const __nv_bfloat16* v,
                                                 int r0, int g4) {
    VTail f;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f.v[i] =
          *reinterpret_cast<const uint32_t*>(v + rows[i] * kLd + kT + 2 * g4);
    return f;
  }
  __device__ __forceinline__ static void v_tail_b(const VTail& f, int nt,
                                                  uint32_t& b0,
                                                  uint32_t& b1) {
    const int sel = nt ? 0x7632 : 0x5410;
    b0 = __byte_perm(f.v[0], f.v[1], sel);
    b1 = __byte_perm(f.v[2], f.v[3], sel);
  }
};

__device__ __forceinline__ uint32_t codes_bf16(uint32_t w, int i) {
  // int8 codes i, i + 1 of w as a bf16 pair (exact)
  const float lo = (float)(int8_t)(w >> (8 * i));
  const float hi = (float)(int8_t)(w >> (8 * (i + 1)));
  return flash::pack_bf16(lo, hi);
}

template <int D>
struct Rows<int8_t, D> {
  static constexpr int kLd = row_ld(D, 1);
  static constexpr int kChunks = D / 16;
  static constexpr int kT = D / 64 * 64;
  __device__ __forceinline__ static int chunk(int, int ch) { return ch; }
  __device__ __forceinline__ static void k_frag(const int8_t* k, int row,
                                                int cb, int q4,
                                                uint32_t b[8]) {
    const uint4 c = *reinterpret_cast<const uint4*>(k + row * kLd + 64 * cb +
                                                    16 * q4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = codes_bf16(word(c, i), 0);
      b[2 * i + 1] = codes_bf16(word(c, i), 2);
    }
  }
  struct VFrag {
    uint2 v[4];
  };
  __device__ __forceinline__ static VFrag v_frag(const int8_t* v, int r0,
                                                 int cb, int g4) {
    VFrag f;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f.v[i] = *reinterpret_cast<const uint2*>(v + rows[i] * kLd +
                                               64 * cb + 8 * g4);
    return f;
  }
  __device__ __forceinline__ static void v_b(const VFrag& f, int nt,
                                             uint32_t& b0, uint32_t& b1) {
    const int sh = 8 * (nt & 3);
    auto code = [&](int i) {
      const uint32_t w = (nt < 4) ? f.v[i].x : f.v[i].y;
      return (float)(int8_t)(w >> sh);
    };
    b0 = flash::pack_bf16(code(0), code(1));
    b1 = flash::pack_bf16(code(2), code(3));
  }
  __device__ __forceinline__ static void k_tail(const int8_t* k, int row,
                                                int q4, uint32_t b[2]) {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(k + row * kLd + kT + 4 * q4);
    b[0] = codes_bf16(w, 0);
    b[1] = codes_bf16(w, 2);
  }
  struct VTail {
    uint32_t v[4];  // the two codes in the low 16 bits
  };
  __device__ __forceinline__ static VTail v_tail(const int8_t* v, int r0,
                                                 int g4) {
    VTail f;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f.v[i] =
          *reinterpret_cast<const uint16_t*>(v + rows[i] * kLd + kT + 2 * g4);
    return f;
  }
  __device__ __forceinline__ static void v_tail_b(const VTail& f, int nt,
                                                  uint32_t& b0,
                                                  uint32_t& b1) {
    auto code = [&](int i) { return (float)(int8_t)(f.v[i] >> (8 * nt)); };
    b0 = flash::pack_bf16(code(0), code(1));
    b1 = flash::pack_bf16(code(2), code(3));
  }
};

// Address sources: where a rank's pages lie.  `entry(j)` names page j of
// the rank's range (-1: no page), `has(e, t)` says whether page e holds a
// key t, and `token(e, t)` is that key's flat token index: K and V rows lie
// at (token KH + kh) D, positions at token, scales at token KH + kh.
struct TablePages {  // K8 / K9: a slot's row of the page table
  const int* table;  // the rank's first entry
  int pg;
  __device__ TablePages(const int* page_table, int slot, int npp, int p0,
                        int pg_, int)
      : table(page_table + (long long)slot * npp + p0), pg(pg_) {}
  __device__ int entry(int j) const { return table[j]; }
  __device__ bool has(int e, int) const { return e >= 0; }
  __device__ long long token(int e, int t) const {
    return (long long)e * pg + t;
  }
};

struct RingPages {  // K6 / K7: row b of a ring cache, as virtual pages
  long long row;    // b L, the row's first token
  int p0, pg, L;
  __device__ RingPages(const int*, int b, int, int p0_, int pg_, int L_)
      : row((long long)b * L_), p0(p0_), pg(pg_), L(L_) {}
  __device__ int entry(int j) const { return p0 + j; }
  __device__ bool has(int e, int t) const { return e * pg + t < L; }
  __device__ long long token(int e, int t) const {
    return row + e * pg + t;
  }
};

template <int D, typename Elem, bool kScaled, typename Src>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const Elem* __restrict__ k_pool,
                        const Elem* __restrict__ v_pool,
                        const __half* __restrict__ k_scale,
                        const __half* __restrict__ v_scale,
                        const int* __restrict__ pos,
                        const int* __restrict__ page_table,
                        const int* __restrict__ qpos, float* __restrict__ out,
                        int KH, int G, int pg, int npp, int len,
                        int has_window, int window, int ppr, int rnd,
                        int nbuf) {
  using R = Rows<Elem, D>;
  static_assert(D % 64 == 0 || D % 64 == 16,
                "a row is 64-column blocks and at most one 16-column tail");
  constexpr int kBlocks = D / 64;        // column blocks of 64 a row
  constexpr int kTail = D % 64 ? 1 : 0;  // then a tail of 16 columns
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L(D, sizeof(Elem), kScaled, G, pg, ppr, rnd, nbuf);
  int* entry_s = reinterpret_cast<int*>(smem + L.entry);
  int* list_s = reinterpret_cast<int*>(smem + L.list);
  uint8_t* pv_s = smem + L.pv;
  uint8_t* vis_s = smem + L.vis;
  int* nvis_s = reinterpret_cast<int*>(smem + L.misc);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int head = blockIdx.x / c;  // row * KH + kv head
  const int slot = head / KH, kh = head % KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, q4 = lane % 4;  // mma row group, thread in group
  const long long qp = qpos[slot];
  const int p0 = rank * ppr;
  const int np = max(0, min(ppr, npp - p0));  // this rank's pages
  const Src pages(page_table, slot, npp, p0, pg, len);

  // Q as S's A fragments, query heads as rows (g4, g4 + 8; zero past G),
  // the head dimension permuted as K's: k-step 4 cb + kk, logical columns
  // (2 q4, 2 q4 + 1 | 2 q4 + 8, 2 q4 + 9) hold elements 64 cb + 16 q4 +
  // 4 kk + (0, 1 | 2, 3); the tail's k-step 4 kBlocks likewise holds
  // elements 64 kBlocks + 4 q4 + (0, 1 | 2, 3).  Loaded first, so that they
  // land during the scan.
  uint32_t qa[4 * kBlocks + kTail][4];
#pragma unroll
  for (int cb = 0; cb < kBlocks; ++cb) {
    const __nv_bfloat16* qh =
        q + (long long)head * G * D + 64 * cb + 16 * q4;
    uint4 r0[2] = {}, r1[2] = {};
    if (g4 < G) {
      r0[0] = *reinterpret_cast<const uint4*>(qh + g4 * D);
      r0[1] = *reinterpret_cast<const uint4*>(qh + g4 * D + 8);
    }
    if (g4 + 8 < G) {
      r1[0] = *reinterpret_cast<const uint4*>(qh + (g4 + 8) * D);
      r1[1] = *reinterpret_cast<const uint4*>(qh + (g4 + 8) * D + 8);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[4 * cb + kk][0] = word(r0[kk >> 1], 2 * (kk & 1));
      qa[4 * cb + kk][1] = word(r1[kk >> 1], 2 * (kk & 1));
      qa[4 * cb + kk][2] = word(r0[kk >> 1], 2 * (kk & 1) + 1);
      qa[4 * cb + kk][3] = word(r1[kk >> 1], 2 * (kk & 1) + 1);
    }
  }
  if constexpr (kTail) {
    const __nv_bfloat16* qh =
        q + (long long)head * G * D + 64 * kBlocks + 4 * q4;
    uint2 r0 = {}, r1 = {};
    if (g4 < G) r0 = *reinterpret_cast<const uint2*>(qh + g4 * D);
    if (g4 + 8 < G) r1 = *reinterpret_cast<const uint2*>(qh + (g4 + 8) * D);
    qa[4 * kBlocks][0] = r0.x;
    qa[4 * kBlocks][1] = r1.x;
    qa[4 * kBlocks][2] = r0.y;
    qa[4 * kBlocks][3] = r1.y;
  }

  // the scan: every key's position in one pass, a flag per key and per
  // page; then warp 0 lists the pages with a visible key, in order
  for (int j = tid; j < np; j += kThreads) pv_s[j] = 0;
  __syncthreads();
  if (qp >= 0) {
#pragma unroll 4
    for (int i = tid; i < np * pg; i += kThreads) {
      const int j = i / pg, t = i - j * pg;
      const int e = pages.entry(j);
      bool v = false;
      if (pages.has(e, t)) {
        const long long kp = pos[pages.token(e, t)];
        v = kp >= 0 && flash::visible_pos(qp, kp, has_window, window);
      }
      vis_s[i] = v;
      if (t == 0) entry_s[j] = e;
      if (v) pv_s[j] = 1;  // every writer writes 1
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < np; base += 32) {
      const int j = base + lane;
      const bool any = j < np && pv_s[j];
      const unsigned bal = __ballot_sync(0xffffffffu, any);
      if (any) list_s[count + __popc(bal & ((1u << lane) - 1u))] = j;
      count += __popc(bal);
    }
    if (lane == 0) *nvis_s = count;
  }
  __syncthreads();
  const int nvis = *nvis_s;
  const int rounds = (nvis + rnd - 1) / rnd;

  // one round's copies: listed pages [r rnd, r rnd + npr) into buffer
  // r % nbuf, rows padded to whole 16-key chunks with zeros
  auto issue = [&](int r) {
    const int b = r % nbuf, first = r * rnd, npr = min(rnd, nvis - first);
    const int nkeys = npr * pg, nrows = round16(nkeys);
    Elem* kb = reinterpret_cast<Elem*>(smem + L.kv) + b * 2 * L.kr * R::kLd;
    Elem* vb = kb + L.kr * R::kLd;
    constexpr int kPer = 16 / sizeof(Elem);  // elements per chunk
    for (int i = tid; i < 2 * nrows * R::kChunks; i += kThreads) {
      const int ch = i % R::kChunks, row = (i / R::kChunks) % nrows;
      const bool is_v = i >= nrows * R::kChunks;
      bool v = false;
      long long tok = 0;
      if (row < nkeys) {
        const int j = list_s[first + row / pg], t = row % pg;
        v = vis_s[j * pg + t];
        tok = pages.token(entry_s[j], t);
      }
      // a key that is not visible is not read, and its address (past the
      // end of a ragged ring row, perhaps) is not handed to the copy
      const Elem* src = (is_v ? v_pool : k_pool) +
                        ((v ? tok : 0) * KH + kh) * D + ch * kPer;
      Elem* dst =
          (is_v ? vb : kb) + row * R::kLd + R::chunk(row, ch) * kPer;
      cp_async16(dst, src, v);
    }
    cp_async_commit();
    uint8_t* rv = smem + L.rv + b * L.kr;
    float* ks = reinterpret_cast<float*>(smem + L.sc) + b * 2 * L.kr;
    for (int row = tid; row < nrows; row += kThreads) {
      bool v = false;
      long long tok = 0;
      if (row < nkeys) {
        const int j = list_s[first + row / pg], t = row % pg;
        v = vis_s[j * pg + t];
        tok = pages.token(entry_s[j], t);
      }
      rv[row] = v;
      if constexpr (kScaled) {
        const long long at = tok * KH + kh;
        ks[row] = v ? __half2float(k_scale[at]) : 0.0f;
        ks[L.kr + row] = v ? __half2float(v_scale[at]) : 0.0f;
      }
    }
  };

  // this warp's online softmax state: rows g4 (m0, l0) and g4 + 8 (m1,
  // l1); l sums only this thread's columns until the end
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  // O's n-tiles: 8 a block, then 2 for a tail
  constexpr int kNt = 8 * kBlocks + 2 * kTail;
  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  if (rounds > 0) issue(0);
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      issue(r + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = r % nbuf;
    const int nch = round16(min(rnd, nvis - r * rnd) * pg) / 16;
    const Elem* kb = reinterpret_cast<const Elem*>(smem + L.kv) +
                     b * 2 * L.kr * R::kLd;
    const Elem* vb = kb + L.kr * R::kLd;
    const uint8_t* rv = smem + L.rv + b * L.kr;
    const float* ks = reinterpret_cast<const float*>(smem + L.sc) +
                      b * 2 * L.kr;
    for (int chunk = warp; chunk < nch; chunk += kWarps) {
      const int k0 = chunk * 16;
      // S = Q K^T over keys k0 .. k0 + 15: two column tiles of 8 keys
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
        for (int cb = 0; cb < kBlocks; ++cb) {
          uint32_t kf[8];
          R::k_frag(kb, k0 + 8 * nt + g4, cb, q4, kf);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            flash::mma_16816(s[nt], qa[4 * cb + kk], kf[2 * kk],
                             kf[2 * kk + 1]);
        }
        if constexpr (kTail) {
          uint32_t kf[2];
          R::k_tail(kb, k0 + 8 * nt + g4, q4, kf);
          flash::mma_16816(s[nt], qa[4 * kBlocks], kf[0], kf[1]);
        }
      }
      // this thread's keys: k0 + 8 nt + 2 q4 + e, e = 0, 1
      bool ok[2][2];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * nt + 2 * q4 + e;
          ok[nt][e] = rv[key];
          float f = 1.0f;
          if constexpr (kScaled) f = ks[key];  // fold the K absmax scale
          s[nt][e] = ok[nt][e] ? s[nt][e] * f : kNeg;
          s[nt][2 + e] = ok[nt][e] ? s[nt][2 + e] * f : kNeg;
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = __expf(m0 - mx0), corr1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float pv[2][4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0v = ok[nt][e] ? __expf(s[nt][e] - mx0) : 0.0f;
          const float p1v = ok[nt][e] ? __expf(s[nt][2 + e] - mx1) : 0.0f;
          sum0 += p0v;  // l keeps the unscaled p
          sum1 += p1v;
          float f = 1.0f;
          if constexpr (kScaled) f = ks[L.kr + k0 + 8 * nt + 2 * q4 + e];
          pv[nt][e] = p0v * f;  // rounded to bf16 below, as the reference
          pv[nt][2 + e] = p1v * f;
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      uint32_t pa[4];
      flash::acc_to_a(pa, pv[0], pv[1]);
      // O += P V over the same 16 keys; O column d = 64 cb + 8 g4 + nt
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb) {
        const typename R::VFrag vf = R::v_frag(vb, k0 + 2 * q4, cb, g4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float* a = acc[8 * cb + nt];
          a[0] *= corr0;
          a[1] *= corr0;
          a[2] *= corr1;
          a[3] *= corr1;
          uint32_t b0, b1;
          R::v_b(vf, nt, b0, b1);
          flash::mma_16816(a, pa, b0, b1);
        }
      }
      if constexpr (kTail) {  // O column 64 kBlocks + 2 g4 + nt
        const typename R::VTail vt = R::v_tail(vb, k0 + 2 * q4, g4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float* a = acc[8 * kBlocks + nt];
          a[0] *= corr0;
          a[1] *= corr0;
          a[2] *= corr1;
          a[3] *= corr1;
          uint32_t b0, b1;
          R::v_tail_b(vt, nt, b0, b1);
          flash::mma_16816(a, pa, b0, b1);
        }
      }
    }
    __syncthreads();  // the buffer is free for round r + 2
  }

  // the warps' partials, in the K / V buffers (every copy has landed and
  // been read: the loop ends on a barrier, or never ran)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* wm = reinterpret_cast<float*>(smem + L.kv);  // [warp][16]
  float* wl = wm + kWarps * kMaxG;                    // [warp][16]
  float* wacc = wl + kWarps * kMaxG;                  // [warp][G][D]
  if (q4 == 0) {
    wm[warp * kMaxG + g4] = m0;
    wm[warp * kMaxG + g4 + 8] = m1;
    wl[warp * kMaxG + g4] = l0;
    wl[warp * kMaxG + g4 + 8] = l1;
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = nt < 8 * kBlocks
                        ? 64 * (nt / 8) + 8 * (2 * q4 + e) + nt % 8
                        : 64 * kBlocks + 2 * (2 * q4 + e) + nt % 8;
      if (g4 < G) wacc[(warp * G + g4) * D + d] = acc[nt][e];
      if (g4 + 8 < G) wacc[(warp * G + g4 + 8) * D + d] = acc[nt][2 + e];
    }
  }
  __syncthreads();
  // the block's partial: the warps' in warp order
  float* bm = reinterpret_cast<float*>(smem + L.part);  // [16]
  for (int i = tid; i < G * D; i += kThreads) {
    const int row = i / D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kMaxG + row]);
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(wm[w * kMaxG + row] - mx);
      a += wacc[(w * G + row) * D + i % D] * f;
      l += wl[w * kMaxG + row] * f;
    }
    bm[2 * kMaxG + i] = a;
    if (i % D == 0) {
      bm[row] = mx;
      bm[kMaxG + row] = l;
    }
  }

  // the cluster's combine, rank by rank: rank `rank` reads every rank's
  // partial of its slice of the (G, D) output and writes it once
  hopper::cluster_arrive(true);
  hopper::cluster_wait();
  {
    const int n = G * D, per = (n + c - 1) / c;
    const int lo = min(n, rank * per), hi = min(n, lo + per);
    float* o = out + (long long)head * n;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int row = i / D;
      float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < c) {
          const float* part = cluster.map_shared_rank(bm, r);
          pm[r] = part[row];
          pl[r] = part[kMaxG + row];
          pa[r] = part[2 * kMaxG + i];
        }
      }
      float mx = kNeg;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < c) mx = fmaxf(mx, pm[r]);
      float a = 0.0f, l = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < c) {
          const float f = __expf(pm[r] - mx);
          a += pa[r] * f;
          l += pl[r] * f;
        }
      }
      o[i] = a / fmaxf(l, 1e-30f);
    }
  }
  // the other ranks' shared memory outlives their readers
  hopper::cluster_arrive(false);
  hopper::cluster_wait();
}

// `len`: a ring row's length (RingPages; TablePages ignores it).
template <int D, typename Elem, bool kScaled, typename Src>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* pos,
           const void* page_table, const void* qpos, void* out, int S,
           int KH, int G, int pg, int npp, int len, int has_window,
           int window, int cluster, int ppr, int rnd, int nbuf, int smem,
           void* stream) {
  if (G < 1 || G > kMaxG || pg < 1 || pg > kMaxPage || S <= 0 || KH <= 0 ||
      npp < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) || ppr < 1 ||
      (long long)ppr * cluster < npp || rnd < 1 || rnd > ppr ||
      (nbuf != 1 && nbuf != 2) || (nbuf == 1 && rnd < ppr) ||
      (long long)S * KH * cluster > 0x7fffffffLL ||
      (long long)ppr * pg > kSmemMax || smem > kSmemMax ||
      smem != Layout(D, sizeof(Elem), kScaled, G, pg, ppr, rnd, nbuf).bytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<D, Elem, kScaled, Src>;
  static int smem_set = 48 * 1024;  // per instantiation, as the attribute
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * KH * cluster);
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
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const Elem*>(k_pool), static_cast<const Elem*>(v_pool),
      static_cast<const __half*>(k_scale),
      static_cast<const __half*>(v_scale), static_cast<const int*>(pos),
      static_cast<const int*>(page_table), static_cast<const int*>(qpos),
      static_cast<float*>(out), KH, G, pg, npp, len, has_window, window,
      ppr, rnd, nbuf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The head width's instantiation: D 64, 128 or 80.
template <typename Elem, bool kScaled, typename Src>
int launch_d(int d, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* pos,
             const void* page_table, const void* qpos, void* out, int S,
             int KH, int G, int pg, int npp, int len, int has_window,
             int window, int cluster, int ppr, int rnd, int nbuf, int smem,
             void* stream) {
  if (d == 64)
    return launch<64, Elem, kScaled, Src>(
        q, k_pool, v_pool, k_scale, v_scale, pos, page_table, qpos, out, S,
        KH, G, pg, npp, len, has_window, window, cluster, ppr, rnd, nbuf,
        smem, stream);
  if (d == 128)
    return launch<128, Elem, kScaled, Src>(
        q, k_pool, v_pool, k_scale, v_scale, pos, page_table, qpos, out, S,
        KH, G, pg, npp, len, has_window, window, cluster, ppr, rnd, nbuf,
        smem, stream);
  if (d == 80)
    return launch<80, Elem, kScaled, Src>(
        q, k_pool, v_pool, k_scale, v_scale, pos, page_table, qpos, out, S,
        KH, G, pg, npp, len, has_window, window, cluster, ppr, rnd, nbuf,
        smem, stream);
  return (int)cudaErrorInvalidValue;
}

// A ring row of L keys as virtual pages of pg; 0 for an L it cannot take.
int ring_pages(int L, int pg) {
  return L < 1 || pg < 1 ? 0 : (int)(((long long)L + pg - 1) / pg);
}

}  // namespace

// The plan, for every entry point (attention_ops.decode_paged_plan):
// clusters of `cluster` blocks (1, 2, 4 or 8) per (row, kv head), `ppr`
// pages a rank, rounds of `rnd` pages in `nbuf` buffers, `smem` bytes of
// dynamic shared memory; `d` the head width D of q, K and V.  Each returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernel does not take.  Requires G <= 16, D 64, 128 or 80, pages of at
// most 64 keys, and 16-byte aligned q and caches (the wrappers check).

// K6.  q (B, KH, G, D) bf16 pre-scaled; caches (B, L, KH, D) bf16 in the
// ring layout, any L; kpos (B, L) int32 (-1 empty); qpos (B,) int32; out
// (B, KH, G, D) fp32.  The row is ceil(L / pg) virtual pages of pg keys.
extern "C" int decode_bf16(const void* q, const void* k, const void* v,
                           const void* kpos, const void* qpos, void* out,
                           int B, int L, int KH, int G, int pg,
                           int has_window, int window, int cluster, int ppr,
                           int rnd, int nbuf, int smem, int d,
                           void* stream) {
  return launch_d<__nv_bfloat16, false, RingPages>(
      d, q, k, v, nullptr, nullptr, kpos, nullptr, qpos, out, B, KH, G, pg,
      ring_pages(L, pg), L, has_window, window, cluster, ppr, rnd, nbuf, smem,
      stream);
}

// K7.  As decode_bf16 over int8 codes (B, L, KH, D) with fp16 scales
// (B, L, KH).
extern "C" int decode_q8(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* kpos, const void* qpos, void* out, int B,
                         int L, int KH, int G, int pg, int has_window,
                         int window, int cluster, int ppr, int rnd, int nbuf,
                         int smem, int d, void* stream) {
  return launch_d<int8_t, true, RingPages>(
      d, q, k, v, k_scale, v_scale, kpos, nullptr, qpos, out, B, KH, G, pg,
      ring_pages(L, pg), L, has_window, window, cluster, ppr, rnd, nbuf, smem,
      stream);
}

// K8.  q (S, KH, G, D) bf16 pre-scaled; pools (P, pg, KH, D) bf16;
// pos_pool (P, pg) int32; page_table (S, npp) int32; qpos (S,) int32; out
// (S, KH, G, D) fp32.
extern "C" int decode_paged_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* pos_pool,
                                 const void* page_table, const void* qpos,
                                 void* out, int S, int KH, int G, int pg,
                                 int npp, int has_window, int window,
                                 int cluster, int ppr, int rnd, int nbuf,
                                 int smem, int d, void* stream) {
  return launch_d<__nv_bfloat16, false, TablePages>(
      d, q, k_pool, v_pool, nullptr, nullptr, pos_pool, page_table, qpos, out,
      S, KH, G, pg, npp, 0, has_window, window, cluster, ppr, rnd, nbuf, smem,
      stream);
}

// K9.  As decode_paged_bf16 over int8 code pools (P, pg, KH, D) with fp16
// scale pools (P, pg, KH).
extern "C" int decode_paged_q8(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* pos_pool,
                               const void* page_table, const void* qpos,
                               void* out, int S, int KH, int G, int pg,
                               int npp, int has_window, int window,
                               int cluster, int ppr, int rnd, int nbuf,
                               int smem, int d, void* stream) {
  return launch_d<int8_t, true, TablePages>(
      d, q, k_pool, v_pool, k_scale, v_scale, pos_pool, page_table, qpos, out,
      S, KH, G, pg, npp, 0, has_window, window, cluster, ppr, rnd, nbuf, smem,
      stream);
}
