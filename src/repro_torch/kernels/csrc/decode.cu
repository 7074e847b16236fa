// Single-token GQA decode attention over a ring KV cache: K6 (bf16) and
// K7 (int8 codes with fp16 absmax scales).
//
// Replaces src/repro/kernels/decode_kernel.py::decode (K6) and ::decode_q8
// (K7), the Pallas kernels behind every step of the static generate loop
// (src/repro/serve/decode.py) with 16-bit and int8 KV caches.
//
// Bound on the H100: bytes (see decode_common.cuh, which holds the sweep).
// One block per (batch row, kv head) loops over the row's cache in 64-row
// tiles, in the native (B, L, KH, D) ring layout.  The Pallas kernels need
// a cache-length block that divides L (pick_block; the reference falls
// back to jnp where none does); here the last tile is masked, so any L is
// taken.  A tile with no visible key (not yet written, or outside the
// window) is skipped, so a windowed sweep costs O(window).
//
// K7 reads the (B, L, KH) fp16 scales where the cache keeps them and widens
// each to fp32 in the kernel.  The reference's wrapper first makes a
// (B, KH, L) fp32 transposed copy of both scale arrays; the values the dots
// see are the same, and one elementwise pass per layer and step is saved.
//
// With B * KH = 4 * 5 = 20 blocks the card is mostly idle at the generate
// shapes.  The paged kernels K8 / K9 (decode_paged.cu) already split a
// slot's sweep over a thread-block cluster with all of a rank's loads in
// flight at once and mma.sync products; doing the same for the ring sweep
// here is the next redesign.
#include "decode_common.cuh"

namespace {

using decode::RingTiles;

template <typename Elem, bool kScaled>
__global__ void __launch_bounds__(decode::kThreads)
    ring_decode_kernel(const __nv_bfloat16* __restrict__ q,
                       const Elem* __restrict__ k, const Elem* __restrict__ v,
                       const __half* __restrict__ k_scale,
                       const __half* __restrict__ v_scale,
                       const int* __restrict__ kpos,
                       const int* __restrict__ qpos, float* __restrict__ out,
                       int L, int KH, int G, int has_window, int window) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const long long head = ((long long)b * KH + kh) * G * decode::D;
  decode::sweep<Elem, kScaled>(RingTiles{(long long)b * L, L}, q + head, k,
                               v, k_scale, v_scale, kpos, KH, kh, G, qpos[b],
                               has_window, window, out + head);
}

bool bad_shape(int B, int L, int KH, int G) {
  return G < 1 || G > decode::kMaxG || B <= 0 || L <= 0 || KH <= 0;
}

}  // namespace

// q (B, KH, G, D) bf16 pre-scaled; caches (B, L, KH, D) bf16; kpos (B, L)
// int32 (-1 empty); qpos (B,) int32; out (B, KH, G, D) fp32.  Requires
// G <= 16, D = 64 and 16-byte aligned caches (the wrapper checks).
// Returns cudaGetLastError().
extern "C" int decode_bf16(const void* q, const void* k, const void* v,
                           const void* kpos, const void* qpos, void* out,
                           int B, int L, int KH, int G, int has_window,
                           int window, void* stream) {
  if (bad_shape(B, L, KH, G)) return (int)cudaErrorInvalidValue;
  ring_decode_kernel<__nv_bfloat16, false>
      <<<dim3(B, KH), decode::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), nullptr, nullptr,
          static_cast<const int*>(kpos), static_cast<const int*>(qpos),
          static_cast<float*>(out), L, KH, G, has_window, window);
  return (int)cudaGetLastError();
}

// As decode_bf16 over int8 codes (B, L, KH, D) with fp16 scales
// (B, L, KH).
extern "C" int decode_q8(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* kpos, const void* qpos, void* out, int B,
                         int L, int KH, int G, int has_window, int window,
                         void* stream) {
  if (bad_shape(B, L, KH, G)) return (int)cudaErrorInvalidValue;
  ring_decode_kernel<int8_t, true>
      <<<dim3(B, KH), decode::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
          static_cast<const __half*>(k_scale),
          static_cast<const __half*>(v_scale), static_cast<const int*>(kpos),
          static_cast<const int*>(qpos), static_cast<float*>(out), L, KH, G,
          has_window, window);
  return (int)cudaGetLastError();
}
