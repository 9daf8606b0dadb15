// Single-token (decode) GQA attention over the stacked paged KV cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_decode.py
// (paged_decode_attention :658 / its pallas_call :742, _decode_kernel). It
// computes the same function: the query of batch row b sits at position
// ctx[b] - 1 and sees every cached key at positions [max(ctx - window, 0),
// ctx); online softmax with f32 accumulation, P rounded to bf16 before P V
// as the reference rounds it to the value dtype; a row with no visible key
// (ctx == 0) outputs zeros (the reference's l == 0 guard); the output is
// bf16. With `softcap` > 0 (Gemma-2) the scaled score becomes
// cap * tanh(score / cap) before the mask (pallas_decode.py:181-183). With
// `sinks` (GPT-OSS; f32 [H], head order kvh * G + g), each head's
// learned logit joins its softmax denominator as a virtual key with no value
// (pallas_decode.py:205-211); nullptr means no sink.
//
// What bounds it on an H100: bytes. Each (row, KV head) reads its live
// context's K and V once (2 * keys * D * 2 bytes) and does ~4 G FLOPs per
// byte read (G = 4 on Llama-3.2-1B), far below the ~295 FLOP/byte the card
// needs to be compute bound.
//
// Design: the split-KV core of paged_splitkv.cuh at S = 1, its G rows one
// 16-row tile (G <= 16; up to 128 rows in more tiles, up to 16 at
// head_dim 256). The grid is (split,
// KV head, batch row), fixed by the block table's width, so a long context
// is walked by many CTAs at once; each CTA streams its chunk's pages
// through a cp.async ring, its four warps score 16 keys of each 64-key tile
// on the tensor cores (mma.sync), and the last split to finish merges the
// splits' f32 partials in split order, so the output is bit-identical from
// call to call. The layer is a runtime index into the stacked cache, so no
// per-layer slice is ever copied.
//
// The fp8 form (paged_decode_fp8) reads e4m3 K/V pages: the core's ring
// holds e4m3 tiles and upcasts each to the bf16 tile the products read
// (paged_splitkv.cuh, kv_fp8.cuh), so it computes bit for bit what the bf16
// form computes over the cache upcast to bf16, from half the bytes; it
// replaces the TPU kernel's fp8 specialization (pallas_decode.py:165-168).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/paged_decode.py.

#include "paged_splitkv.cuh"

namespace {

int decode(const void* q, const void* k, const void* v, const void* bt,
           const void* ctx, const void* sinks, void* out, void* ws, void* cnt,
           int B, int H, int KVH, int D, int N, int bs, int W, int layer,
           int window, int chunk, int nsplit, float scale, float softcap,
           bool fp8, void* stream) {
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  paged_splitkv::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = k;
  p.vc = v;
  p.bt = static_cast<const int*>(bt);
  p.base_pos = nullptr;  // decode: the query sits at ctx - 1
  p.ctx_lens = static_cast<const int*>(ctx);
  p.sinks = static_cast<const float*>(sinks);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(cnt);
  p.S = 1;
  p.Sq = 1;
  p.H = H;
  p.KVH = KVH;
  p.G = H / KVH;
  p.N = N;
  p.bs = bs;
  p.W = W;
  p.layer = layer;
  p.window = window;
  p.chunk = chunk;
  p.scale = scale;
  p.softcap = softcap;
  return paged_splitkv::launch_any(p, B, D, nsplit, fp8,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked types, shapes, contiguity, 16-byte alignment and the group
// size (G <= 128, 16 at head_dim 256); it allocates the workspace `ws` (f32, B * KVH * nsplit
// * G * (D + 2)) and passes its device's counter buffer `cnt` (>= B * KVH
// ints, zero between calls), both unused when nsplit == 1. `sinks` is f32
// [H] or nullptr. `softcap` > 0 caps the scores (0 = off). head_dim 64, 96,
// 128 and 256 are instantiated. q and out are bf16; k and v are bf16 here ...
extern "C" int paged_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* bt, const void* ctx,
                                 const void* sinks, void* out, void* ws,
                                 void* cnt, int B, int H, int KVH,
                                 int D, int N, int bs, int W, int layer,
                                 int window, int chunk, int nsplit,
                                 float scale, float softcap, void* stream) {
  return decode(q, k, v, bt, ctx, sinks, out, ws, cnt, B, H, KVH, D, N, bs, W,
                layer, window, chunk, nsplit, scale, softcap, false, stream);
}

// ... and e4m3 (torch.float8_e4m3fn, no scale) here.
extern "C" int paged_decode_fp8(const void* q, const void* k, const void* v,
                                const void* bt, const void* ctx,
                                const void* sinks, void* out, void* ws,
                                void* cnt, int B, int H, int KVH,
                                int D, int N, int bs, int W, int layer,
                                int window, int chunk, int nsplit,
                                float scale, float softcap, void* stream) {
  return decode(q, k, v, bt, ctx, sinks, out, ws, cnt, B, H, KVH, D, N, bs, W,
                layer, window, chunk, nsplit, scale, softcap, true, stream);
}
