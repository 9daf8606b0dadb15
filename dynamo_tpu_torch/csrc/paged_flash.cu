// Flash attention of an S-token query chunk over the stacked paged KV cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_attention.py
// (paged_flash_attention / _kernel). It computes the same function under
// the same affine-position contract: query token s of batch row b sits at
// position base_pos[b] + s and sees key j iff j <= qpos, j < ctx[b] and
// j > qpos - window (pallas_attention.py:94-95); a row with no visible key
// outputs zeros (the l == 0 guard, :142). Rows past ctx give values the
// caller discards, never NaN: a query tile whose first position is at or
// past ctx writes zeros and reads nothing. With `sinks` (GPT-OSS; f32 [H],
// head order kvh * G + g), each head's learned logit joins its softmax
// denominator as a virtual key with no value (pallas_attention.py:135-143):
// at the finalize, l <- l * 2^(m - m') + 2^(sink * log2 e - m') with the
// shift m' = max(m, sink * log2 e), so neither term overflows and a row with
// no visible key still writes 0. With `softcap` > 0 (Gemma-2) the scaled
// score becomes cap * tanh(score / cap) before the mask
// (pallas_attention.py:109-110).
//
// What bounds it on an H100: for a long chunk, operations — each K/V tile
// is reused by every query row of the CTA, so the FLOPs per byte grow with
// the chunk. The TPU kernel's sequential page grid axis becomes a loop
// inside the CTA over only the keys the CTA's query tile can see (from the
// window's first visible key to min(ctx - 1, last query position)).
//
// Design: one CTA (one warpgroup) per (query tile, KV head, batch row); its
// 64 rows are (query position, group head) pairs, floor(64 / G) positions
// times the G query heads that share the KV head, any G up to 64 (G 7: 9
// positions and one spare row, which loads zeros and stores nothing; one
// warpgroup: a short chunk or a chunk with few live query tiles keeps more
// CTAs). The tile loop is
// the shared tensor-core core of paged_attn_tc.cuh (cp.async ring, wgmma
// bf16 products with f32 accumulators, online softmax on the fragments)
// with the causal / ctx / window mask; P is rounded to bf16 before P V, as
// the reference rounds it to the value dtype (pallas_attention.py:122). The
// epilogue divides by l and stores bf16.
//
// The fp8 form (paged_flash_fp8) reads e4m3 K/V pages: the core's ring
// holds e4m3 tiles and upcasts each into the bf16 tile the wgmma products
// read (paged_attn_tc.cuh, kv_fp8.cuh), so it computes bit for bit what
// the bf16 form computes over the cache upcast to bf16, from half the
// bytes; it replaces the TPU kernel's fp8 specialization
// (pallas_attention.py:100-102).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/paged_flash.py.

#include "paged_attn_tc.cuh"

namespace {

using namespace paged_attn_tc;

// warpgroups a CTA
constexpr int kWG = 1;
constexpr int kRows = cta_rows<kWG>();
constexpr int kThreads = cta_threads<kWG>();

template <int D, bool kCap, bool kFp8>
__global__ void __launch_bounds__(kThreads) paged_flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, S, H, D]
    const void* __restrict__ kc,            // [L, N, bs, KVH, D] bf16 / e4m3
    const void* __restrict__ vc,            // [L, N, bs, KVH, D]
    const int* __restrict__ bt,             // [B, W]
    const int* __restrict__ base_pos,       // [B]
    const int* __restrict__ ctx_lens,       // [B]
    const float* __restrict__ sinks,        // [H] or nullptr
    __nv_bfloat16* __restrict__ out,        // [B, S, H, D]
    int S, int H, int KVH, int N, int bs, int W, int layer, int window,
    float scale, float softcap) {
  extern __shared__ unsigned char smem[];
  const int G = H / KVH;
  const int BQ = kRows / G;  // whole query positions per CTA
  const int s0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int ctx = ctx_lens[b];
  const int base = base_pos[b];
  const int s_end = min(s0 + BQ, S);

  if (base + s0 >= ctx) {
    // every row of the tile lies past ctx: the caller discards them
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const int s = s0 + r / G;  // a spare row's lies past s_end
      if (s >= s_end) continue;
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * S + s) * H + kvh * G + r % G) * D + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  Problem p{q, kc, vc, bt + (size_t)b * W, S, H, KVH, G, N, bs, layer,
            b, kvh, s0, scale, softcap};
  // the keys this query tile can see at all
  const int k_lo = max(0, base + s0 - window + 1);
  const int k_hi = min(ctx - 1, base + s_end - 1);  // inclusive
  RowState<D> st;
  attend<D, kWG, /*kCausal=*/true, /*kSplitP=*/false, kCap, kFp8>(
      p, base, window, k_lo, k_hi + 1, smem, st);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * i;
    const int s = s0 + r / G;  // a spare row's lies past s_end
    if (s >= s_end) continue;
    float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
    if (sinks) {
      const float sk = sinks[kvh * G + r % G] * kLog2e;
      const float sh = fmaxf(st.m[i], sk);
      const float w = st.m[i] == -INFINITY ? 0.f : ex2(st.m[i] - sh);
      inv = w / (st.l[i] * w + ex2(sk - sh));
    }
    __nv_bfloat16* orow =
        out + (((size_t)b * S + s) * H + kvh * G + r % G) * D + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + t * 8) = __floats2bfloat162_rn(
          st.o[t][2 * i] * inv, st.o[t][2 * i + 1] * inv);
  }
}

template <int D, bool kFp8>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* base, const void* ctx, const void* sinks, void* out,
           int B, int S, int H, int KVH, int N, int bs, int W, int layer,
           int window, float scale, float softcap, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set[2];
  constexpr int smem = smem_bytes<D, kWG, kFp8>();
  static_assert(smem <= 232448, "a CTA's shared memory must fit an H100");
  const bool cap = softcap > 0.f;
  const auto kernel = cap ? paged_flash_tc_kernel<D, true, kFp8>
                          : paged_flash_tc_kernel<D, false, kFp8>;
  cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(kernel),
                                    smem, smem_set[cap]);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KVH;
  const int BQ = kRows / G;
  const dim3 grid((S + BQ - 1) / BQ, KVH, B);
  kernel<<<grid, dim3(kThreads), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const int*>(bt),
      static_cast<const int*>(base), static_cast<const int*>(ctx),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), S,
      H, KVH, N, bs, W, layer, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool kFp8>
int flash(const void* q, const void* k, const void* v, const void* bt,
          const void* base, const void* ctx, const void* sinks, void* out,
          int B, int S, int H, int KVH, int D, int N, int bs, int W, int layer,
          int window, float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, kFp8>(q, k, v, bt, base, ctx, sinks, out, B, S, H, KVH,
                            N, bs, W, layer, window, scale, softcap, s);
  if (D == 128)
    return launch<128, kFp8>(q, k, v, bt, base, ctx, sinks, out, B, S, H, KVH,
                             N, bs, W, layer, window, scale, softcap, s);
  if (D == 256)
    return launch<256, kFp8>(q, k, v, bt, base, ctx, sinks, out, B, S, H, KVH,
                             N, bs, W, layer, window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked types, shapes, contiguity, 16-byte alignment, that head_dim
// is 64, 128 or 256 (the three instantiations) and that the group size
// G = H / KVH is at most 64. `sinks` is f32 [H] or nullptr; `softcap` > 0 caps
// the scores (0 = off). q and out are bf16; k and v are bf16 here ...
extern "C" int paged_flash_bf16(const void* q, const void* k, const void* v,
                                const void* bt, const void* base,
                                const void* ctx, const void* sinks, void* out,
                                int B, int S, int H, int KVH, int D, int N,
                                int bs, int W, int layer, int window,
                                float scale, float softcap, void* stream) {
  return flash<false>(q, k, v, bt, base, ctx, sinks, out, B, S, H, KVH, D, N,
                      bs, W, layer, window, scale, softcap, stream);
}

// ... and e4m3 (torch.float8_e4m3fn, no scale) here.
extern "C" int paged_flash_fp8(const void* q, const void* k, const void* v,
                               const void* bt, const void* base,
                               const void* ctx, const void* sinks, void* out,
                               int B, int S, int H, int KVH, int D, int N,
                               int bs, int W, int layer, int window,
                               float scale, float softcap, void* stream) {
  return flash<true>(q, k, v, bt, base, ctx, sinks, out, B, S, H, KVH, D, N,
                     bs, W, layer, window, scale, softcap, stream);
}
