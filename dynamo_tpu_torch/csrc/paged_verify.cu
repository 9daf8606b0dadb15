// Speculative-verify attention: 1 < S <= 32 query tokens per batch row over
// one shared walk of the stacked paged KV cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_decode.py
// (paged_verify_attention :550 / its pallas_call :634, _verify_kernel). It
// computes the same function under the flash kernel's affine-position
// contract: query token s of row b sits at position base_pos[b] + s and
// sees key j iff j <= base + s, j < ctx[b] and j > base + s - window
// (pallas_decode.py:495-499). The keys walked run from query 0's window
// bound to min(ctx - 1, base + S - 1), so every live K/V page of the row is
// read once for all S queries; P is rounded to bf16 before P V, as the
// reference rounds it to the value dtype. A row with no visible key
// outputs zeros, never NaN (rows past ctx are discarded by the caller).
// With `softcap` > 0 (Gemma-2) the scaled score becomes cap * tanh(score /
// cap) before the mask (pallas_decode.py:506-507). With `sinks` (GPT-OSS; f32 [H], head order kvh * G + g), each head's
// learned logit joins its softmax denominator as a virtual key with no value
// (pallas_decode.py:527-537); nullptr means no sink.
//
// What bounds it on an H100: bytes. The CTA's Sq * G query rows (at most
// 128) reuse each K/V element staged in shared memory, so the work is at
// most ~128 FLOPs per byte read, under the ~295 FLOP/byte at which the
// card turns compute bound.
//
// Design: the split-KV core of paged_splitkv.cuh with its rows the
// (query position, group head) pairs r = s * G + g, padded to 16-row
// tiles (S 5 at G 4: 20 rows, two tiles, each scored by two warps over 32
// keys of every 64-key tile). A row's S queries are cut into parts of Sq
// positions with Sq * G <= 128, 16 at head_dim 256 (S 17 at G 8: parts of
// 9 and 8 positions, two CTAs over the same keys; at G 2 and head_dim 256:
// 6, 6 and 5). The grid is (split, part x KV head, batch
// row), fixed by the block table's width and S; K and V stay bf16 in a cp.async ring
// and both products run on the tensor cores (mma.sync, ldmatrix); the last
// split to finish merges the splits' f32 partials in split order.
//
// The fp8 form (paged_verify_fp8) reads e4m3 K/V pages through the same
// core (paged_splitkv.cuh, kv_fp8.cuh): bit for bit the bf16 form over the
// cache upcast to bf16, from half the bytes; it replaces the TPU kernel's
// fp8 specialization (pallas_decode.py:492-493).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/paged_verify.py.

#include "paged_splitkv.cuh"

namespace {

int verify(const void* q, const void* k, const void* v, const void* bt,
           const void* base, const void* ctx, const void* sinks, void* out,
           void* ws, void* cnt, int B, int S, int Sq, int H, int KVH, int D,
           int N, int bs, int W, int layer, int window, int chunk, int nsplit,
           float scale, float softcap, bool fp8, void* stream) {
  if (KVH <= 0 || H % KVH || S < 2) return (int)cudaErrorInvalidValue;
  paged_splitkv::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = k;
  p.vc = v;
  p.bt = static_cast<const int*>(bt);
  p.base_pos = static_cast<const int*>(base);
  p.ctx_lens = static_cast<const int*>(ctx);
  p.sinks = static_cast<const float*>(sinks);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(cnt);
  p.S = S;
  p.Sq = Sq;
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
// has checked types, shapes, contiguity, 16-byte alignment, 1 < S <= 32,
// H / KVH and Sq * (H / KVH) <= 128, 16 at head_dim 256 (ops/splitkv.py
// query_parts picks Sq); it allocates the workspace `ws` (f32, B * parts * KVH * nsplit
// * Sq * G * (D + 2)) and passes its device's counter buffer `cnt`
// (>= B * parts * KVH ints, zero between calls), both unused when
// nsplit == 1. `sinks` is f32 [H] or nullptr. `softcap` > 0 caps the
// scores (0 = off). head_dim 64, 128 and 256 are instantiated. q and out
// are bf16; k and v are bf16 here ...
extern "C" int paged_verify_bf16(const void* q, const void* k, const void* v,
                                 const void* bt, const void* base,
                                 const void* ctx, const void* sinks,
                                 void* out, void* ws, void* cnt, int B, int S,
                                 int Sq, int H, int KVH,
                                 int D, int N, int bs, int W, int layer,
                                 int window, int chunk, int nsplit,
                                 float scale, float softcap, void* stream) {
  return verify(q, k, v, bt, base, ctx, sinks, out, ws, cnt, B, S, Sq, H, KVH,
                D, N, bs, W, layer, window, chunk, nsplit, scale, softcap,
                false, stream);
}

// ... and e4m3 (torch.float8_e4m3fn, no scale) here.
extern "C" int paged_verify_fp8(const void* q, const void* k, const void* v,
                                const void* bt, const void* base,
                                const void* ctx, const void* sinks,
                                void* out, void* ws, void* cnt, int B, int S,
                                int Sq, int H, int KVH,
                                int D, int N, int bs, int W, int layer,
                                int window, int chunk, int nsplit,
                                float scale, float softcap, void* stream) {
  return verify(q, k, v, bt, base, ctx, sinks, out, ws, cnt, B, S, Sq, H, KVH,
                D, N, bs, W, layer, window, chunk, nsplit, scale, softcap,
                true, stream);
}
