// Speculative-verify attention: 1 < S <= 32 query tokens per batch row over
// one shared walk of the stacked paged KV cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_decode.py
// (paged_verify_attention / _verify_kernel). It computes the same function
// under the flash kernel's affine-position contract: query token s of row b
// sits at position base_pos[b] + s and sees key j iff j <= base + s,
// j < ctx[b] and j > base + s - window (pallas_decode.py:495-499). The walk
// starts at query 0's window bound and ends at min(ctx - 1, base + S - 1),
// so every live K/V page of the row is read once for all S queries. A row
// with no visible key outputs zeros, never NaN (rows past ctx are
// discarded by the caller).
//
// What bounds it on an H100: bytes. The CTA's S * G query rows (at most
// 32 * 4 = 128) reuse each K/V element staged in shared memory, so the
// work is at most ~128 FLOPs per byte read, under the ~295 FLOP/byte at
// which the card turns compute bound.
//
// Design: one CTA (256 threads) per (KV head, batch row) — the TPU grid's
// per-row program, split over KV heads so B * KVH CTAs run. Its rows are
// (query position, group head) pairs, row r = s * G + g, so one 64-key
// K/V tile in shared memory (f32) feeds every query of the group. Each
// thread owns an 8-row by 4-key block of the score tile and an 8-row by
// D/16-column block of the output; row statistics (online softmax, f32)
// reduce over the 16 threads of a row group with warp shuffles. Warps
// whose 16 rows all lie past S * G skip the math. Scalar f32 FMAs, no
// async copies: a first version that is simple and right; tensor-core
// tiles and TMA double buffering are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/paged_verify.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 128;    // query rows per CTA: (position, group head)
constexpr int TK = 64;    // keys per shared-memory tile
constexpr int NT = 256;   // threads per CTA: 16 row groups of 16 threads
constexpr int VEC = 8;    // bf16 elements per 16-byte load
constexpr int RPT = 8;    // rows per thread
constexpr int KPT = 4;    // keys per thread in the score tile

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
__global__ void __launch_bounds__(NT) paged_verify_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, S, H, D]
    const __nv_bfloat16* __restrict__ kc,   // [L, N, bs, KVH, D]
    const __nv_bfloat16* __restrict__ vc,   // [L, N, bs, KVH, D]
    const int* __restrict__ bt,             // [B, W]
    const int* __restrict__ base_pos,       // [B]
    const int* __restrict__ ctx_lens,       // [B]
    __nv_bfloat16* __restrict__ out,        // [B, S, H, D]
    int S, int H, int KVH, int N, int bs, int W, int layer, int window,
    float scale) {
  constexpr int QS = D + 1;    // padded Q row
  constexpr int KTS = TK + 1;  // padded transposed-K row
  constexpr int PS = TK + 1;   // padded P row
  constexpr int DC = D / 16;   // output columns per thread
  constexpr int VPR = D / VEC;
  extern __shared__ float smem[];
  float* q_s = smem;            // [R][QS]
  float* kt_s = q_s + R * QS;   // [D][KTS]  (K transposed)
  float* v_s = kt_s + D * KTS;  // [TK][D]
  float* p_s = v_s + TK * D;    // [R][PS]

  const int G = H / KVH;
  const int rows = S * G;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int rb = tid >> 4;  // row group: rows rb*8 .. rb*8+7
  const int cx = tid & 15;
  // a warp holds two row groups (16 rows); it idles when all lie past S*G
  const bool warp_rows = (tid >> 5) * 2 * RPT < rows;
  const int ctx = ctx_lens[b];
  const int base = base_pos[b];

  for (int i = tid; i < R * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float f[VEC];
    if (r < rows) {
      const int s = r / G, g = r % G;
      load_bf16x8(q + (((size_t)b * S + s) * H + kvh * G + g) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * QS + c + e] = f[e];
  }

  // the keys any query of the row can see: query 0's window bound up to
  // the last query position (or the last valid key)
  const int k_lo = max(0, base - window + 1);
  const int k_hi = min(ctx - 1, base + S - 1);  // inclusive

  int qpos[RPT];
  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qpos[i] = base + (rb * RPT + i) / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const size_t tok_stride = (size_t)KVH * D;
  const size_t layer_base =
      (size_t)layer * N * bs * tok_stride + (size_t)kvh * D;

  for (int t0 = k_lo; t0 <= k_hi; t0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TK * VPR; i += NT) {
      const int j = i / VPR, c = (i % VPR) * VEC;
      const int pos = t0 + j;
      float kf[VEC], vf[VEC];
      if (pos <= k_hi) {
        const int blk = bt[(size_t)b * W + pos / bs];
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
    if (!warp_rows) continue;

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
      float tmax = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const int kp = t0 + cx + 16 * kk;
        const bool ok = kp <= k_hi && kp <= qpos[i] && kp > qpos[i] - window;
        sc[i][kk] = ok ? sc[i][kk] * scale : -INFINITY;
        tmax = fmaxf(tmax, sc[i][kk]);
      }
      // the 16 threads of a row group are 16 consecutive lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      // a row with no visible key yet keeps p = 0 (no -inf - -inf NaN)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        const float p =
            sc[i][kk] == -INFINITY ? 0.f : __expf(sc[i][kk] - m_use);
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
    if (r >= rows) continue;
    const int s = r / G, g = r % G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = out + (((size_t)b * S + s) * H + kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[cx + 16 * c] = __float2bfloat16(acc[i][c] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* base, const void* ctx, void* out, int B, int S, int H,
           int KVH, int N, int bs, int W, int layer, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)R * (D + 1) +
                                       (size_t)D * (TK + 1) +
                                       (size_t)TK * D + (size_t)R * (TK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_verify_kernel<D><<<dim3(KVH, B), dim3(NT), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(base), static_cast<const int*>(ctx),
      static_cast<__nv_bfloat16*>(out), S, H, KVH, N, bs, W, layer, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked types, shapes, contiguity, 16-byte alignment, 1 < S <= 32
// and S * (H / KVH) <= 128. Only head_dim 64 (Llama-3.2-1B) is
// instantiated.
extern "C" int paged_verify_bf16(const void* q, const void* k, const void* v,
                                 const void* bt, const void* base,
                                 const void* ctx, void* out, int B, int S,
                                 int H, int KVH, int D, int N, int bs, int W,
                                 int layer, int window, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && S * (H / KVH) <= R)
    return launch<64>(q, k, v, bt, base, ctx, out, B, S, H, KVH, N, bs, W,
                      layer, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
