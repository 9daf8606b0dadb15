// Online-softmax partials of a query shard against the committed paged
// prefix, for sequence-parallel prefill.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_sp.py
// (paged_prefix_attention_partials / _prefix_kernel). It computes the same
// function: every query row of batch row b scores the keys at cache
// positions j < prefix_len (pages 0 .. ceil(prefix_len / bs) - 1 of b's
// block table, the last page's tail masked; no causal term), and writes
// the UNNORMALISED partials: m (the running max of the scaled scores),
// l = sum exp(s - m) and acc = sum exp(s - m) * v. With prefix_len == 0
// nothing is read and every row gets m = MASK_VALUE (-1e30, finite, so the
// caller's merge never meets -inf - -inf), l = 0, acc = 0.
//
// What bounds it on an H100: operations. Each K/V tile staged in shared
// memory is reused by all 128 rows of a CTA, and the same prefix is read by
// every query tile of every rank (the sp ranks are the batch rows, all
// with one block table). The TPU kernel's double-buffered page walk
// becomes a loop inside the CTA over 64-key tiles of the prefix.
//
// Design: one CTA per (query tile, KV head, batch row) of TWO warpgroups,
// 128 rows of (query position, group head) pairs, 64 a warpgroup (floor(128
// / G) whole positions at any G up to 128; G 5: 25 positions and 3 spare
// rows, which load zeros and store nothing), both
// reading every K/V stage (measured against one warpgroup of 64 rows on an
// H100: 0.98 against 1.23 ms at the SP chunk's shape; PERF.md). The tile
// loop is the shared tensor-core core of paged_attn_tc.cuh (cp.async
// ring, wgmma bf16 products with f32 accumulators, online softmax on the
// fragments); only the prefix's last tile is masked. P enters P V as bf16
// hi + lo (kSplitP): the reference rounds P to bf16 once
// (pallas_sp.py:147), an error of up to 2^-9 a term, the order of the
// 1e-3 to which acc is held against the f32 plain version; the split
// keeps P to ~16 bits for one more product per 16-key step. l is the f32
// sum of P before any rounding. The epilogue writes acc, m (natural log
// domain) and l in the layout the caller merges.
//
// The block table's row stride is an argument: the caller passes one row
// broadcast over the ranks (stride 0) instead of a copy per rank.
//
// The fp8 form (sp_prefix_partials_fp8) reads an e4m3 cache (no scale):
// the ring holds e4m3 tiles and each landed tile is upcast into the one
// bf16 K and V tile the products read (kv_fp8.cuh, the core's kFp8 walk,
// as the flash kernel's fp8 form does), so it computes bit for bit what
// the bf16 form computes over the cache upcast to bf16, from half the
// bytes. It replaces the TPU kernel's fp8 upcast (pallas_sp.py:127-129).
// Two warpgroups at head_dim 128 take 115,712 bytes of shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/sp_prefix.py.

#include "paged_attn_tc.cuh"

namespace {

using namespace paged_attn_tc;

// warpgroups a CTA
constexpr int kWG = 2;
constexpr int kRows = cta_rows<kWG>();
constexpr int kThreads = cta_threads<kWG>();

constexpr float MASK_VALUE = -1e30f;

template <int D, bool kFp8>
__global__ void __launch_bounds__(kThreads) sp_prefix_tc_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, S, H, D]
    const void* __restrict__ kc,            // [L, N, bs, KVH, D] bf16 / e4m3
    const void* __restrict__ vc,            // [L, N, bs, KVH, D]
    const int* __restrict__ bt,             // row b at bt + b * bt_stride
    float* __restrict__ acc_out,            // [B, S, H, D] = [B, S, KVH, G, D]
    float* __restrict__ m_out,              // [B, S, H]
    float* __restrict__ l_out,              // [B, S, H]
    int S, int H, int KVH, int N, int bs, int bt_stride, int prefix_len,
    int layer, float scale) {
  extern __shared__ unsigned char smem[];
  const int G = H / KVH;
  const int BQ = kRows / G;  // whole query positions per CTA
  const int s0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int s_end = min(s0 + BQ, S);

  if (prefix_len == 0) {
    // the empty prefix: exact empties, nothing read
    constexpr int CH = D / 4;  // 16-byte chunks of an f32 row
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const int s = s0 + r / G;  // a spare row's lies past s_end
      if (s >= s_end) continue;
      const size_t row = ((size_t)b * S + s) * H + kvh * G + r % G;
      *reinterpret_cast<float4*>(acc_out + row * D + c * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
      if (c == 0) {
        m_out[row] = MASK_VALUE;
        l_out[row] = 0.f;
      }
    }
    return;
  }

  Problem p{q, kc, vc, bt + (size_t)b * bt_stride, S, H, KVH, G, N, bs,
            layer, b, kvh, s0, scale};
  RowState<D> st;
  attend<D, kWG, /*kCausal=*/false, /*kSplitP=*/true, /*kCap=*/false, kFp8>(
      p, 0, 0, 0, prefix_len, smem, st);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * i;
    const int s = s0 + r / G;  // a spare row's lies past s_end
    if (s >= s_end) continue;
    const size_t row = ((size_t)b * S + s) * H + kvh * G + r % G;
    float* arow = acc_out + row * D + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<float2*>(arow + t * 8) =
          make_float2(st.o[t][2 * i], st.o[t][2 * i + 1]);
    if ((lane & 3) == 0) {
      // every row saw a live key (prefix_len > 0): m is finite
      m_out[row] = st.m[i] * kLn2;
      l_out[row] = st.l[i];
    }
  }
}

template <int D, bool kFp8>
int launch(const void* q, const void* k, const void* v, const void* bt,
           void* acc, void* m, void* l, int B, int S, int H, int KVH, int N,
           int bs, int bt_stride, int prefix_len, int layer, float scale,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes<D, kWG, kFp8>();
  static_assert(smem <= 232448, "a CTA's shared memory must fit an H100");
  cudaError_t err = allow_smem_once(
      reinterpret_cast<const void*>(sp_prefix_tc_kernel<D, kFp8>), smem,
      smem_set);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KVH;
  const int BQ = kRows / G;
  const dim3 grid((S + BQ - 1) / BQ, KVH, B);
  sp_prefix_tc_kernel<D, kFp8><<<grid, dim3(kThreads), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const int*>(bt),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, H, KVH, N, bs, bt_stride, prefix_len, layer,
      scale);
  return (int)cudaGetLastError();
}

template <bool kFp8>
int partials(const void* q, const void* k, const void* v, const void* bt,
             void* acc, void* m, void* l, int B, int S, int H, int KVH, int D,
             int N, int bs, int bt_stride, int prefix_len, int layer,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, kFp8>(q, k, v, bt, acc, m, l, B, S, H, KVH, N, bs,
                            bt_stride, prefix_len, layer, scale, s);
  if (D == 128)
    return launch<128, kFp8>(q, k, v, bt, acc, m, l, B, S, H, KVH, N, bs,
                             bt_stride, prefix_len, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked types, shapes, contiguity, 16-byte alignment, that head_dim
// is 64 or 128 (the two instantiations), that the group size G = H / KVH
// is at most 128, that prefix_len fits the block table (W pages of bs keys)
// and that layer is in range. q is bf16; k and v are bf16 here ...
extern "C" int sp_prefix_partials_bf16(const void* q, const void* k,
                                       const void* v, const void* bt,
                                       void* acc, void* m, void* l, int B,
                                       int S, int H, int KVH, int D, int N,
                                       int bs, int W, int bt_stride,
                                       int prefix_len, int layer, float scale,
                                       void* stream) {
  (void)W;
  return partials<false>(q, k, v, bt, acc, m, l, B, S, H, KVH, D, N, bs,
                         bt_stride, prefix_len, layer, scale, stream);
}

// ... and e4m3 (torch.float8_e4m3fn, no scale) here.
extern "C" int sp_prefix_partials_fp8(const void* q, const void* k,
                                      const void* v, const void* bt,
                                      void* acc, void* m, void* l, int B,
                                      int S, int H, int KVH, int D, int N,
                                      int bs, int W, int bt_stride,
                                      int prefix_len, int layer, float scale,
                                      void* stream) {
  (void)W;
  return partials<true>(q, k, v, bt, acc, m, l, B, S, H, KVH, D, N, bs,
                        bt_stride, prefix_len, layer, scale, stream);
}
