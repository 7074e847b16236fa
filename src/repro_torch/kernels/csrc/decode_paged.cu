// Paged single-token GQA decode attention: K8 (bf16 pools) and K9 (int8
// pools with fp16 absmax scale pools).
//
// Replaces src/repro/kernels/decode_kernel.py::decode_paged (K8) and
// ::decode_paged_q8 (K9), the Pallas kernels behind every decode tick of
// the serving engine with 16-bit and int8 KV pools.
//
// Bound on the H100: bytes (see decode_common.cuh, which holds the sweep).
// One block per (slot, kv head) loops over the slot's pages.  Hopper has no
// scalar prefetch: each block reads its own page-table row and loads each
// page's K and V rows straight from where they lie in the pool, so no
// gathered copy of the cache is made.  A -1 page is clamped to page 0 for
// the address and masked out; a page with no visible key is skipped.  A
// slot with qpos = -1 or no visible key returns 0, as the reference's
// paged references do.
//
// K9 reads the (P, pg, KH) fp16 scale pools where they lie and widens each
// scale to fp32 in the kernel, where the reference's wrapper makes a
// (P, KH, pg) fp32 transposed copy first: the same values, one elementwise
// pass per layer and tick saved.
//
// With S * KH = 4 * 5 = 20 blocks the card is mostly idle at the slice's
// shapes; splitting the page sweep across blocks (flash-decoding) is a later
// redesign.
#include "decode_common.cuh"

namespace {

using decode::PagedTiles;

template <typename Elem, bool kScaled>
__global__ void __launch_bounds__(decode::kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const Elem* __restrict__ k_pool,
                        const Elem* __restrict__ v_pool,
                        const __half* __restrict__ k_scale,
                        const __half* __restrict__ v_scale,
                        const int* __restrict__ pos_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ qpos, float* __restrict__ out,
                        int KH, int G, int pg, int npp, int has_window,
                        int window) {
  const int slot = blockIdx.x, kh = blockIdx.y;
  const long long head = ((long long)slot * KH + kh) * G * decode::D;
  decode::sweep<Elem, kScaled>(
      PagedTiles{page_table + (long long)slot * npp, npp, pg}, q + head,
      k_pool, v_pool, k_scale, v_scale, pos_pool, KH, kh, G, qpos[slot],
      has_window, window, out + head);
}

bool bad_shape(int S, int KH, int G, int pg) {
  return G < 1 || G > decode::kMaxG || pg < 1 || pg > decode::kTile ||
         S <= 0 || KH <= 0;
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
  if (bad_shape(S, KH, G, pg)) return (int)cudaErrorInvalidValue;
  paged_decode_kernel<__nv_bfloat16, false>
      <<<dim3(S, KH), decode::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k_pool),
          static_cast<const __nv_bfloat16*>(v_pool), nullptr, nullptr,
          static_cast<const int*>(pos_pool),
          static_cast<const int*>(page_table), static_cast<const int*>(qpos),
          static_cast<float*>(out), KH, G, pg, npp, has_window, window);
  return (int)cudaGetLastError();
}

// As decode_paged_bf16 over int8 code pools (P, pg, KH, D) with fp16 scale
// pools (P, pg, KH).
extern "C" int decode_paged_q8(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* pos_pool,
                               const void* page_table, const void* qpos,
                               void* out, int S, int KH, int G, int pg,
                               int npp, int has_window, int window,
                               void* stream) {
  if (bad_shape(S, KH, G, pg)) return (int)cudaErrorInvalidValue;
  paged_decode_kernel<int8_t, true>
      <<<dim3(S, KH), decode::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const int8_t*>(k_pool),
          static_cast<const int8_t*>(v_pool),
          static_cast<const __half*>(k_scale),
          static_cast<const __half*>(v_scale),
          static_cast<const int*>(pos_pool),
          static_cast<const int*>(page_table), static_cast<const int*>(qpos),
          static_cast<float*>(out), KH, G, pg, npp, has_window, window);
  return (int)cudaGetLastError();
}
