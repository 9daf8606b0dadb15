// DeepSeek MLA single-token (decode) attention over the stacked compressed
// latent cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_decode.py
// (mla_paged_decode_attention / _mla_decode_kernel). It computes the same
// function: for batch row b and query head h,
//   score[t] = scale * (q_lat[h] . c[t] + q_rope[h] . kr[t])   for t < ctx[b]
//   out[h]   = sum_t softmax(score)[t] * c[t]                  (over R)
// walking the pages of block_tables[b] in layer `layer` of the stacked
// caches c [L, N, bs, 1, R] and kr [L, N, bs, 1, RD], with f32 accumulation;
// a row with no key (ctx == 0) outputs zeros, never NaN (the reference's
// l == 0 guard); the output is bf16 [B, 1, H, R]. The caches are unpadded
// (the reference pads R and RD to 128 lanes for the TPU's DMA; here RD = 64
// would be half padding).
//
// What bounds it on an H100: bytes. One key is (R + RD) * 2 = 1,152 bytes
// at DeepSeek-V2/V3 widths, shared by every query head; the value is the
// latent itself. The design reads each live key from device memory once per
// CTA: a 64-key tile of [c | kr] (72 KB of bf16) is staged in shared memory
// and every head of the CTA's group (up to 16) scores against it there, and
// the same tile's c serves the P.V product.
//
// The TPU kernel's grid has one step per batch row: at a decode batch of 8
// that would be 8 CTAs on 132 SMs. So the context is split (flash-decoding):
// grid (row, split, head group), each CTA walks `kps` keys and writes its
// unnormalised partial (acc, m, l); a second kernel merges the live splits
// of each (row, head). Splits past a row's ctx exit at once.
//
// Known limits of this first version (later work): scalar f32 FMAs from
// shared memory (the two products are [16 x 576] x [576 x 64] and
// [16 x 64] x [64 x 512] per tile, tensor-core shaped: mma.sync / wgmma),
// no overlap of the next tile's loads with this tile's math, and R == 512,
// RD == 64 only (DeepSeek-V2, V2-Lite and V3).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/mla_decode.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;   // keys per shared-memory tile
constexpr int HG = 16;   // query heads per CTA
constexpr int NT = 256;  // threads per CTA (8 warps; warp w scores heads 2w, 2w+1)
constexpr int MT = 128;  // threads per merge CTA

// a 32-bit word holding two bf16 (element 0 in the low half) as two floats
__device__ __forceinline__ float2 bf2f(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int R, int RD>
__global__ void __launch_bounds__(NT) mla_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q_lat,   // [B, H, R]
    const __nv_bfloat16* __restrict__ q_rope,  // [B, H, RD]
    const __nv_bfloat16* __restrict__ cc,      // [L, N, bs, R]
    const __nv_bfloat16* __restrict__ krc,     // [L, N, bs, RD]
    const int* __restrict__ bt,                // [B, W]
    const int* __restrict__ ctx_lens,          // [B]
    float* __restrict__ part_acc,              // [B, S, H, R]
    float* __restrict__ part_ml,               // [B, S, H, 2]
    int H, int N, int bs, int W, int layer, int kps, int splits, float scale) {
  constexpr int D = R + RD;     // key width in elements (576)
  constexpr int DW = D / 2;     // 32-bit words per key (288)
  constexpr int KS = DW + 1;    // padded row stride: lane j reads row j bank-free
  constexpr int CCH = R / 8;    // 16-byte chunks of c per key
  constexpr int KCH = CCH + RD / 8;
  static_assert(R == 2 * NT, "P.V gives each thread one bf16 pair of the latent");
  static_assert(HG == 2 * (NT / 32), "each warp scores two heads");
  static_assert(TK == 64, "each lane scores two keys of a tile");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                            // [HG][D]
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + HG * D);    // [TK][KS]
  float* p_s = reinterpret_cast<float*>(k_s + TK * KS);         // [TK][HG]
  float* alpha_s = p_s + TK * HG;                               // [HG]

  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int h0 = blockIdx.z * HG;
  const int hg = min(HG, H - h0);
  const int ctx = ctx_lens[b];
  const int t_begin = split * kps;
  if (t_begin >= ctx) return;  // a dead split: the merge never reads it
  const int t_end = min(t_begin + kps, ctx);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < HG * D; i += NT) {
    const int h = i / D, d = i % D;
    float v = 0.f;
    if (h < hg) {
      const size_t row = (size_t)b * H + h0 + h;
      v = d < R ? __bfloat162float(q_lat[row * R + d])
                : __bfloat162float(q_rope[row * RD + (d - R)]);
    }
    q_s[i] = v;
  }

  const size_t c_base = (size_t)layer * N * bs * R;
  const size_t kr_base = (size_t)layer * N * bs * RD;
  const int ha = 2 * warp, hb = ha + 1;
  float m_a = -INFINITY, l_a = 0.f, m_b = -INFINITY, l_b = 0.f;
  float acc[HG][2];
#pragma unroll
  for (int h = 0; h < HG; ++h) acc[h][0] = acc[h][1] = 0.f;

  // every tile starts at a visible key (t0 < t_end), so each tile's running
  // max is finite
  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();  // q_s is written; the previous tile's readers are done
    for (int i = tid; i < TK * KCH; i += NT) {
      const int r = i / KCH, ch = i % KCH;
      const int pos = t0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (pos < t_end) {
        const size_t tok = (size_t)bt[(size_t)b * W + pos / bs] * bs + pos % bs;
        raw = ch < CCH
                  ? *reinterpret_cast<const uint4*>(cc + c_base + tok * R + ch * 8)
                  : *reinterpret_cast<const uint4*>(krc + kr_base + tok * RD +
                                                    (ch - CCH) * 8);
      }
      uint32_t* dst = k_s + r * KS + ch * 4;
      dst[0] = raw.x; dst[1] = raw.y; dst[2] = raw.z; dst[3] = raw.w;
    }
    __syncthreads();

    // scores of heads ha, hb against keys lane and lane + 32, then this
    // tile's online-softmax step for those two heads, all in this warp
    {
      const float2* qa = reinterpret_cast<const float2*>(q_s + ha * D);
      const float2* qb = reinterpret_cast<const float2*>(q_s + hb * D);
      const uint32_t* k0 = k_s + lane * KS;
      const uint32_t* k1 = k_s + (lane + 32) * KS;
      float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll 8
      for (int p = 0; p < DW; ++p) {
        const float2 a = qa[p], bq = qb[p];
        const float2 x0 = bf2f(k0[p]), x1 = bf2f(k1[p]);
        sa0 = fmaf(a.x, x0.x, fmaf(a.y, x0.y, sa0));
        sa1 = fmaf(a.x, x1.x, fmaf(a.y, x1.y, sa1));
        sb0 = fmaf(bq.x, x0.x, fmaf(bq.y, x0.y, sb0));
        sb1 = fmaf(bq.x, x1.x, fmaf(bq.y, x1.y, sb1));
      }
      const bool v0 = t0 + lane < t_end, v1 = t0 + lane + 32 < t_end;
      sa0 = v0 ? sa0 * scale : -INFINITY;
      sb0 = v0 ? sb0 * scale : -INFINITY;
      sa1 = v1 ? sa1 * scale : -INFINITY;
      sb1 = v1 ? sb1 * scale : -INFINITY;

      const float ma_new = fmaxf(m_a, warp_max(fmaxf(sa0, sa1)));
      const float mb_new = fmaxf(m_b, warp_max(fmaxf(sb0, sb1)));
      const float pa0 = v0 ? __expf(sa0 - ma_new) : 0.f;
      const float pa1 = v1 ? __expf(sa1 - ma_new) : 0.f;
      const float pb0 = v0 ? __expf(sb0 - mb_new) : 0.f;
      const float pb1 = v1 ? __expf(sb1 - mb_new) : 0.f;
      const float alpha_a = __expf(m_a - ma_new);
      const float alpha_b = __expf(m_b - mb_new);
      l_a = l_a * alpha_a + warp_sum(pa0 + pa1);
      l_b = l_b * alpha_b + warp_sum(pb0 + pb1);
      m_a = ma_new;
      m_b = mb_new;
      p_s[lane * HG + ha] = pa0;
      p_s[(lane + 32) * HG + ha] = pa1;
      p_s[lane * HG + hb] = pb0;
      p_s[(lane + 32) * HG + hb] = pb1;
      if (lane == 0) {
        alpha_s[ha] = alpha_a;
        alpha_s[hb] = alpha_b;
      }
    }
    __syncthreads();

    // P.V: this thread's latent pair (columns 2 tid, 2 tid + 1) for every
    // head, from the same shared tile
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float a = alpha_s[h];
      acc[h][0] *= a;
      acc[h][1] *= a;
    }
    const int nk = min(TK, t_end - t0);
    for (int j = 0; j < nk; ++j) {
      const float2 cv = bf2f(k_s[j * KS + tid]);
      const float4* pr = reinterpret_cast<const float4*>(p_s + j * HG);
#pragma unroll
      for (int q = 0; q < HG / 4; ++q) {
        const float4 p = pr[q];
        acc[4 * q + 0][0] = fmaf(p.x, cv.x, acc[4 * q + 0][0]);
        acc[4 * q + 0][1] = fmaf(p.x, cv.y, acc[4 * q + 0][1]);
        acc[4 * q + 1][0] = fmaf(p.y, cv.x, acc[4 * q + 1][0]);
        acc[4 * q + 1][1] = fmaf(p.y, cv.y, acc[4 * q + 1][1]);
        acc[4 * q + 2][0] = fmaf(p.z, cv.x, acc[4 * q + 2][0]);
        acc[4 * q + 2][1] = fmaf(p.z, cv.y, acc[4 * q + 2][1]);
        acc[4 * q + 3][0] = fmaf(p.w, cv.x, acc[4 * q + 3][0]);
        acc[4 * q + 3][1] = fmaf(p.w, cv.y, acc[4 * q + 3][1]);
      }
    }
  }

  const size_t part = ((size_t)b * splits + split) * H + h0;
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (h < hg) {
      *reinterpret_cast<float2*>(part_acc + (part + h) * R + 2 * tid) =
          make_float2(acc[h][0], acc[h][1]);
    }
  }
  if (lane == 0) {
    if (ha < hg) {
      part_ml[(part + ha) * 2] = m_a;
      part_ml[(part + ha) * 2 + 1] = l_a;
    }
    if (hb < hg) {
      part_ml[(part + hb) * 2] = m_b;
      part_ml[(part + hb) * 2 + 1] = l_b;
    }
  }
}

// One CTA per (row, head): merges the row's live splits (those starting
// before ctx) into the normalised bf16 output; zeros for a row with none.
template <int R>
__global__ void __launch_bounds__(MT) mla_decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ ctx_lens, __nv_bfloat16* __restrict__ out, int H,
    int kps, int splits) {
  static_assert(R == 4 * MT, "each merge thread owns four latent columns");
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ctx = ctx_lens[b];
  const int ns = ctx > 0 ? min(splits, (ctx + kps - 1) / kps) : 0;
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s)
    mx = fmaxf(mx, part_ml[(((size_t)b * splits + s) * H + h) * 2]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < ns; ++s) {
    const size_t row = ((size_t)b * splits + s) * H + h;
    const float w = __expf(part_ml[row * 2] - mx);
    l = fmaf(part_ml[row * 2 + 1], w, l);
    const float4 v = *reinterpret_cast<const float4*>(part_acc + row * R + 4 * tid);
    a.x = fmaf(v.x, w, a.x);
    a.y = fmaf(v.y, w, a.y);
    a.z = fmaf(v.z, w, a.z);
    a.w = fmaf(v.w, w, a.w);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat16* o = out + ((size_t)b * H + h) * R + 4 * tid;
  o[0] = __float2bfloat16(a.x * inv);
  o[1] = __float2bfloat16(a.y * inv);
  o[2] = __float2bfloat16(a.z * inv);
  o[3] = __float2bfloat16(a.w * inv);
}

template <int R, int RD>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* kr,
           const void* bt, const void* ctx, void* part_acc, void* part_ml,
           void* out, int B, int H, int N, int bs, int W, int layer, int kps,
           int splits, float scale, cudaStream_t stream) {
  constexpr int D = R + RD;
  const size_t smem =
      sizeof(float) * ((size_t)HG * D + (size_t)TK * (D / 2 + 1) +
                       (size_t)TK * HG + HG);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_split_kernel<R, RD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, splits, (H + HG - 1) / HG);
  mla_decode_split_kernel<R, RD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q_lat),
      static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(kr),
      static_cast<const int*>(bt), static_cast<const int*>(ctx),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, N, bs, W,
      layer, kps, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_merge_kernel<R><<<dim3(B, H), MT, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(ctx), static_cast<__nv_bfloat16*>(out), H, kps,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 = launched). The
// wrapper has checked types, shapes, contiguity and 16-byte alignment, and
// allocated the partials part_acc [B, splits, H, R] and part_ml
// [B, splits, H, 2] (f32); kps is a multiple of 64. Only R = 512, RD = 64
// (DeepSeek-V2, V2-Lite, V3) is instantiated.
extern "C" int mla_decode_bf16(const void* q_lat, const void* q_rope,
                               const void* c, const void* kr, const void* bt,
                               const void* ctx, void* part_acc, void* part_ml,
                               void* out, int B, int H, int R, int RD, int N,
                               int bs, int W, int layer, int kps, int splits,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 512 && RD == 64 && kps > 0 && kps % TK == 0)
    return launch<512, 64>(q_lat, q_rope, c, kr, bt, ctx, part_acc, part_ml,
                           out, B, H, N, bs, W, layer, kps, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
