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
// memory is reused by all 64 rows of a CTA, and the same prefix is read by
// every query tile of every rank (the sp ranks are the batch rows, all
// with one block table). The TPU kernel's double-buffered page walk
// becomes a loop inside the CTA over 64-key tiles of the prefix.
//
// Design: the tile scheme of paged_flash.cu. One CTA (128 threads) per
// (query tile, KV head, batch row); its 64 rows are (query position, group
// head) pairs — 64 / G positions times the G query heads of the KV head —
// so one K/V tile (64 keys, f32 in shared memory) feeds all of them. Each
// thread owns an 8-row by 4-key block of the score tile and an 8-row by
// D/16-column block of the accumulator; the row statistics reduce across
// the 16 threads of a row group with warp shuffles. Scalar f32 FMAs: a
// first version that is simple and right. Tensor-core tiles (mma.sync or
// wgmma on [64 x 64] x [64 x 64]) and TMA / cp.async stages are later work.
//
// The block table's row stride is an argument: the caller passes one row
// broadcast over the ranks (stride 0) instead of a copy per rank.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/sp_prefix.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 64;     // query rows per CTA: (position, group head)
constexpr int TK = 64;    // keys per shared-memory tile
constexpr int NT = 128;   // threads per CTA
constexpr int VEC = 8;    // bf16 elements per 16-byte load
constexpr int RPT = 8;    // rows per thread
constexpr int KPT = 4;    // keys per thread in the score tile
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* src,
                                            float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) sp_prefix_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, S, H, D]
    const __nv_bfloat16* __restrict__ kc,   // [L, N, bs, KVH, D]
    const __nv_bfloat16* __restrict__ vc,   // [L, N, bs, KVH, D]
    const int* __restrict__ bt,             // row b at bt + b * bt_stride
    float* __restrict__ acc_out,            // [B, S, H, D] = [B, S, KVH, G, D]
    float* __restrict__ m_out,              // [B, S, H]
    float* __restrict__ l_out,              // [B, S, H]
    int S, int H, int KVH, int N, int bs, int bt_stride, int prefix_len,
    int layer, float scale) {
  constexpr int QS = D + 1;    // padded Q row (two row groups per warp)
  constexpr int KTS = TK + 1;  // padded transposed-K row
  constexpr int PS = TK + 1;   // padded P row
  constexpr int DC = D / 16;   // accumulator columns per thread
  constexpr int VPR = D / VEC;
  extern __shared__ float smem[];
  float* q_s = smem;            // [R][QS]
  float* kt_s = q_s + R * QS;   // [D][KTS]  (K transposed)
  float* v_s = kt_s + D * KTS;  // [TK][D]
  float* p_s = v_s + TK * D;    // [R][PS]

  const int G = H / KVH;
  const int BQ = R / G;  // query positions per CTA
  const int s0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rb = tid >> 4;  // row group: rows rb*8 .. rb*8+7
  const int cx = tid & 15;
  const int* btab = bt + (size_t)b * bt_stride;

  for (int i = tid; i < R * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int s = s0 + r / G, g = r % G;
    float f[VEC];
    if (s < S) {
      load_bf16x8(q + (((size_t)b * S + s) * H + kvh * G + g) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * QS + c + e] = f[e];
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const size_t tok_stride = (size_t)KVH * D;
  const size_t layer_base =
      (size_t)layer * N * bs * tok_stride + (size_t)kvh * D;

  // every tile holds at least one live key (t0 < prefix_len), so after the
  // first tile each row's m is a real score and masked keys give p = 0
  for (int t0 = 0; t0 < prefix_len; t0 += TK) {
    __syncthreads();  // the previous tile's readers are done (and q_s is in)
    for (int i = tid; i < TK * VPR; i += NT) {
      const int j = i / VPR, c = (i % VPR) * VEC;
      const int pos = t0 + j;
      float kf[VEC], vf[VEC];
      if (pos < prefix_len) {
        const int blk = btab[pos / bs];
        const size_t off =
            layer_base + ((size_t)blk * bs + pos % bs) * tok_stride + c;
        load_bf16x8(kc + off, kf);
        load_bf16x8(vc + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kt_s[(c + e) * KTS + j] = kf[e];
        v_s[j * D + c + e] = vf[e];
      }
    }
    __syncthreads();

    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) sc[i][kk] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) kv[kk] = kt_s[d * KTS + cx + 16 * kk];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = q_s[(rb * RPT + i) * QS + d];
#pragma unroll
        for (int kk = 0; kk < KPT; ++kk) sc[i][kk] = fmaf(qv, kv[kk], sc[i][kk]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tmax = MASK_VALUE;
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const bool live = t0 + cx + 16 * kk < prefix_len;
        sc[i][kk] = live ? sc[i][kk] * scale : -INFINITY;
        tmax = fmaxf(tmax, sc[i][kk]);
      }
      // the 16 threads of a row group are 16 consecutive lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = __expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const float p =
            sc[i][kk] == -INFINITY ? 0.f : __expf(sc[i][kk] - m_new);
        p_s[(rb * RPT + i) * PS + cx + 16 * kk] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row group's P rows are written by its own warp

#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[j * D + cx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = p_s[(rb * RPT + i) * PS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rb * RPT + i;
    const int s = s0 + r / G;
    if (s >= S) continue;
    const int g = r % G;
    const size_t row = ((size_t)b * S + s) * H + kvh * G + g;
    float* arow = acc_out + row * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) arow[cx + 16 * c] = acc[i][c];
    if (cx == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bt,
           void* acc, void* m, void* l, int B, int S, int H, int KVH, int N,
           int bs, int bt_stride, int prefix_len, int layer, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)R * (D + 1) +
                                       (size_t)D * (TK + 1) +
                                       (size_t)TK * D + (size_t)R * (TK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      sp_prefix_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KVH;
  const int BQ = R / G;
  const dim3 grid((S + BQ - 1) / BQ, KVH, B);
  sp_prefix_kernel<D><<<grid, dim3(NT), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(bt),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, H, KVH, N, bs, bt_stride, prefix_len, layer,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked types, shapes, contiguity, 16-byte alignment, that the group
// size G = H / KVH divides 64, that prefix_len fits the block table (W
// pages of bs keys) and that layer is in range. Only head_dim 64
// (Llama-3.2-1B) is instantiated.
extern "C" int sp_prefix_partials_bf16(const void* q, const void* k,
                                       const void* v, const void* bt,
                                       void* acc, void* m, void* l, int B,
                                       int S, int H, int KVH, int D, int N,
                                       int bs, int W, int bt_stride,
                                       int prefix_len, int layer, float scale,
                                       void* stream) {
  (void)W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, bt, acc, m, l, B, S, H, KVH, N, bs, bt_stride,
                      prefix_len, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}
