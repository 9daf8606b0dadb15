// The split-KV ("flash-decoding") core shared by the two short-query
// attention kernels: csrc/paged_decode.cu (S = 1, TPU kernel
// dynamo_tpu/ops/pallas_decode.py::paged_decode_attention) and
// csrc/paged_verify.cu (1 < S <= 32, pallas_decode.py::paged_verify_attention).
//
// The function. Query token s of batch row b sits at position base + s
// (decode: base = ctx - 1) and sees key j iff j <= base + s, j < ctx and
// j > base + s - window. A CTA's rows are (query position, group head)
// pairs, r = s * G + g, so every K/V tile it stages feeds all its rows of
// its KV head; a row with no visible key outputs zeros, never NaN. With
// `sinks` (GPT-OSS), head h's learned logit joins each row's softmax as a
// virtual key with no value: only the denominator grows, by exp(sink - m)
// (pallas_decode.py:205-211 and :527-537).
//
// What bounds it on an H100: bytes. Each live K/V element is read once and
// does at most 4 * S * G FLOPs (<= 128 FLOP/byte at S * G = 128, ~16 at
// decode), under the ~295 FLOP/byte at which the card turns compute bound.
// So the design keeps enough CTAs in flight and enough copies outstanding
// to stream the live pages, and spends few instructions on the products.
//
// Grid: (split, query part x KV head, batch row), from tensor shapes only.
// A CTA holds Sq query positions (Sq * G <= 128 rows); the S queries of a
// row are cut into ceil(S / Sq) parts, each its own CTA over the same keys
// (GPT-OSS's verify at S 17 and G 8: 136 rows, two parts of 9 and 8
// positions), and a part is for the rest of this note a row of its own
// with its own base (base + the part's first query). The block
// table's width W * bs is cut into chunks of `chunk` keys (a multiple of
// the 64-key tile; ops/splitkv.py picks it), one CTA a chunk. Each CTA
// reads ctx (and base) on the device and computes the range every row of
// its KV head can see, [k_lo, k_hi] = [max(0, base - window + 1),
// min(ctx - 1, base + S - 1)]; a CTA whose chunk lies outside it exits at
// once. Nothing on the host reads ctx, so a launch needs no sync and can be
// captured in a CUDA graph.
//
// Inside a CTA (4 warps; 8 for 128 rows). The chunk's block-table entries
// are read once into shared memory. K and V tiles of 64 keys x D stay bf16:
// cp.async copies of 16 bytes into a ring of kStages stages, chunks
// XOR-swizzled by row % 8 so that ldmatrix reads them without bank
// conflicts; the copies of the next tiles are in flight while this tile's
// products run. Q K^T and P V run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix (.trans for V),
// the S * G rows padded to M tiles of 16 rows: wgmma's 64-row tile would
// leave most rows idle at decode's G = 4. With one or two row tiles the
// warps split each tile's keys among themselves (16 or 32 keys a warp), so
// all four warps compute; each keeps its own online softmax (f32, log2
// domain) and its own accumulators, and the warps merge in shared memory
// at the end. P is rounded to bf16 before P V, as the reference rounds it
// to the value dtype; l is summed from f32 P. Only tiles at the range's
// edges and on the causal diagonal or the window's edge are masked.
//
// Merging the splits. A chunk that holds the whole range writes the bf16
// output itself. Otherwise each live split writes its unnormalised
// (m, l, acc) in f32 to a workspace the wrapper allocates, and the last
// CTA of the (row, KV head) to finish (a __threadfence and an atomic
// counter; the counters live in a buffer the wrapper keeps zeroed, and the
// last CTA sets its counter back to 0) merges every live split in split
// order and writes the output. No float atomics: the result does not depend
// on which CTA finishes last, so repeated calls are bit-identical. One
// launch a call.
//
// The sink enters once a row, at whichever of the two exits writes it: the
// single live split's store, or the last split's merge. Scores live in the
// log2 domain, so the sink enters as sink * log2(e), and the shift is
// max(m, sink * log2 e): neither exponential overflows when a sink exceeds
// every score, and a row with no visible key (m = -inf) still writes 0.
//
// The softcap (Gemma-2; 0 = off) replaces the scaled score by
// cap * tanh(scale * q.k / cap) (pallas_decode.py:181-183 and :506-507).
// It is applied to the raw dot products of each tile, in natural-log
// units times log2 e, before the mask: a masked key must stay -inf, which
// tanh would turn into -cap. The capped tile is then already in the log2
// domain, so the softmax takes it with a factor of 1 where it otherwise
// folds scale * log2 e in. The cap is a template argument: the forms
// without it compile to the walk they had before it existed. tanh is 1 - 2 / (2^(2 x log2 e) + 1) on ex2.approx:
// measured on an H100 over scores in [-200, 200] at a cap of 50, its
// largest error is 1.2e-5 of a logit, against 5.2e-6 for tanhf and 4.0e-4
// for tanh.approx.f32, which ran ~5% faster in flash at head_dim 256 and
// no faster here (scripts/softcap_tanh_error.py; PERF.md).
//
// head_dim 256 (Gemma-2-9b). A warp's 16 x 256 f32 accumulator is 128
// registers a thread, so a CTA holds one 16-row tile (its four warps
// split each tile's keys, 16 keys a warp): with two or more row tiles a
// warp scores 32 or 64 keys at a time and ptxas spilled at 255 registers
// (ops/splitkv.py cuts the S * G rows into query parts of at most 16; a
// group of more than 16 heads is refused). The warps read Q's fragments
// from shared memory at each k-step instead of holding them (D / 16 x 4 =
// 64 more registers). The three-stage ring of 64-key tiles is then 192 KB,
// which leaves room for a split's block-table entries up to ~6,600 pages
// (ops/splitkv.py refuses a larger split by name; two stages ran 4-5%
// slower). At 64 and 128 all of it stays as it was.
//
// fp8 caches (kFp8; e4m3 K and V, the reference's kv_cache_dtype="fp8").
// The ring holds kStages e4m3 tiles of K and of V (half the bytes of a
// bf16 stage), and one bf16 K and one bf16 V tile: after the barrier that
// publishes tile it, every thread upcasts its 16-byte e4m3 chunks of that
// tile into the bf16 tiles at the swizzled places the bf16 ring would hold
// them (csrc/kv_fp8.cuh), and a second barrier publishes them to the
// products. The rest of the walk is the bf16 form's, so the fp8 form over
// an e4m3 cache is bit for bit the bf16 form over the cache upcast to
// bf16, and it reads half the bytes. Its shared memory is 5 bf16 tiles'
// worth against 6: at head_dim 256, 160 KB of ring beside the bf16 form's
// 192 KB. Q, the output, the sinks and the workspace stay bf16 / f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kv_fp8.cuh"

// Everything here has internal linkage: the two kernels' libraries each
// include this header, and a function-local static of an inline function
// with external linkage (the per-device shared-memory attribute record of
// `launch`) would be one object across both loaded libraries while each
// library holds its own kernel.
namespace paged_splitkv {
namespace {

constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kStages = 3;  // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRows = 128;  // Sq * G rows a CTA holds: 8 row tiles

// M row tiles of 16 rows: warps split a tile's keys while there are few
// row tiles (M 1: 4 warps x 16 keys; M 2: 2 x 2 warps x 32 keys), and own
// one row tile each over all 64 keys from M 4 on
__host__ __device__ constexpr int key_groups(int m) {
  return m == 1 ? 4 : m == 2 ? 2 : 1;
}
__host__ __device__ constexpr int cta_threads(int m) {
  return 32 * m * key_groups(m);
}
// (query position, group head) rows a CTA holds: one 16-row tile at
// head_dim 256 (see the note above), kMaxRows below
__host__ __device__ constexpr int max_rows(int d) {
  return d >= 256 ? 16 : kMaxRows;
}
// the dynamic shared memory a CTA may take on an H100 (227 KB)
constexpr int kSmemLimit = 232448;

// The launch's arguments. base_pos == nullptr: decode (base = ctx - 1,
// S = 1). sinks == nullptr: no sink. kc / vc hold bf16, or e4m3 in the
// fp8 form.
struct Params {
  const __nv_bfloat16* q;   // [B, S, H, D]
  const void* kc;           // [L, N, bs, KVH, D]
  const void* vc;           // [L, N, bs, KVH, D]
  const int* bt;            // [B, W]
  const int* base_pos;      // [B] or nullptr
  const int* ctx_lens;      // [B]
  __nv_bfloat16* out;       // [B, S, H, D]
  const float* sinks;       // [H] sink logits or nullptr
  float* ws;                // [B, parts * KVH, nsplit, Sq * G, D + 2] f32
  int* cnt;                 // [>= B * parts * KVH] split counters, zero
                            // between calls
  int S, Sq, H, KVH, G, N, bs, W, layer, window, chunk;
  float scale;
  float softcap;            // 0: off
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] holds (row lane / 4, columns 2 (lane % 4) + {0, 1})
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh x = 1 - 2 / (e^(2x) + 1), e^(2x) on ex2.approx; the exponent is
// clamped so the sum stays finite (tanh is 1 in f32 well before)
__device__ __forceinline__ float tanh_ex2(float x) {
  const float e = ex2(fminf(2.f * kLog2e * x, 64.f));
  return 1.f - __fdividef(2.f, e + 1.f);
}

// ---------------------------------------------------------------- helpers

// two floats -> bf16x2 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four floats -> bf16 at dst (8-byte aligned)
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a,
                                             float b, float c, float d) {
  uint2 v;
  v.x = pack_bf16(a, b);
  v.y = pack_bf16(c, d);
  *reinterpret_cast<uint2*>(dst) = v;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of
// D bf16: chunks XOR-swizzled by row % 8, so the 8 rows an ldmatrix reads
// at one chunk index fall on 8 distinct bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (D * 2) + ((chunk ^ (row & 7)) << 4));
}

// the K and V rings: kStages bf16 tiles each, or (kFp8) one bf16 tile
// each and kStages e4m3 tiles each
template <int D, bool kFp8>
__host__ __device__ constexpr int ring_bytes() {
  return kFp8 ? 2 * kKeys * D * 2 + 2 * kStages * kKeys * D
              : 2 * kStages * kKeys * D * 2;
}

// dynamic shared memory: Q (16 M rows), the K and V rings, the merge's row
// statistics, the last-CTA flag, then the chunk's block-table entries
// (ops/splitkv.py smem_bytes mirrors it)
template <int D, int M, bool kFp8>
__host__ __device__ constexpr int smem_fixed() {
  return 16 * M * D * 2 + ring_bytes<D, kFp8>() + 2 * kMaxRows * 4 + 16;
}
template <int D, int M, bool kFp8>
inline size_t smem_bytes(int chunk, int bs) {
  return (size_t)smem_fixed<D, M, kFp8>() + (size_t)(chunk / bs + 2) * 4;
}

// the sink of head `head` in the log2 domain, or -inf without sinks
__device__ __forceinline__ float sink_l2(const Params& p, int head) {
  return p.sinks ? p.sinks[head] * kLog2e : -INFINITY;
}

// exp2(x - shift), 0 for x = -inf (a split or a row with no visible key)
__device__ __forceinline__ float ex2_from(float x, float shift) {
  return x == -INFINITY ? 0.f : ex2(x - shift);
}

// ------------------------------------------------------------- the kernel

template <int D, int M, bool kCap, bool kFp8>
__global__ void __launch_bounds__(cta_threads(M)) splitkv_kernel(
    const Params p) {
  constexpr int WK = key_groups(M);    // warps sharing a row tile
  constexpr int NT = cta_threads(M);
  constexpr int KW = kKeys / WK;       // keys a warp scores per tile
  constexpr int NTL = KW / 8;          // its 8-key score tiles
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int DT = D / 8;            // 8-column output tiles
  constexpr int ROWS = 16 * M;
  constexpr uint32_t kTile = kKeys * D * 2;
  constexpr uint32_t kTile8 = kKeys * D;  // an e4m3 tile
  constexpr int CH8 = D / 16;          // 16-byte chunks per e4m3 row
  constexpr int kBufs = kFp8 ? 1 : kStages;  // bf16 K (and V) tiles
  constexpr int DS = D + 4;            // f32 row stride of the warps' dump
  constexpr bool kHoldQ = D <= 128;    // Q's fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y % p.KVH, s0 = blockIdx.y / p.KVH * p.Sq;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int rt = warp / WK, kg = warp % WK;  // row tile, key group
  // this CTA's query positions s0 .. s0 + S - 1; RS the workspace's rows
  const int S = min(p.Sq, p.S - s0), G = p.G, R = S * G, RS = p.Sq * G;
  const int ctx = p.ctx_lens[b];
  const int base = (p.base_pos ? p.base_pos[b] : ctx - 1) + s0;
  const int k_lo = max(0, base - p.window + 1);
  const int k_hi = min(ctx - 1, base + S - 1);  // inclusive

  // output row r = s * G + g: query s0 + s, head kvh * G + g
  auto out_row = [&](int r) {
    return p.out + (((size_t)b * p.S + s0 + r / G) * p.H + kvh * G + r % G) *
                       D;
  };

  if (k_hi < k_lo) {  // no key visible to any row: split 0 writes zeros
    if (split == 0)
      for (int i = tid; i < R * (D / 4); i += NT)
        store_bf16x4(out_row(i / (D / 4)) + (i % (D / 4)) * 4, 0.f, 0.f, 0.f,
                     0.f);
    return;
  }
  const int sp_lo = k_lo / p.chunk, sp_hi = k_hi / p.chunk;
  if (split < sp_lo || split > sp_hi) return;
  const int nlive = sp_hi - sp_lo + 1;
  const int key_begin = max(k_lo, split * p.chunk);
  const int key_end = min(k_hi + 1, (split + 1) * p.chunk);

  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + ROWS * D * 2;
  const uint32_t v_s = k_s + kBufs * kTile;
  const uint32_t k8_s = v_s + kBufs * kTile;  // the e4m3 rings (kFp8)
  const uint32_t v8_s = k8_s + kStages * kTile8;
  auto sm = [&](uint32_t a) { return smem + (a - q_s); };  // generic pointer
  float* stat_s =
      reinterpret_cast<float*>(smem + ROWS * D * 2 + ring_bytes<D, kFp8>());
  int* flag_s = reinterpret_cast<int*>(stat_s + 2 * kMaxRows);
  int* pages_s = flag_s + 4;

  // Q: row r is (query s0 + r / G, head kvh * G + r % G); zeros past R
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < R;
    const __nv_bfloat16* src =
        p.q + (((size_t)b * p.S + s0 + (ok ? r / G : 0)) * p.H + kvh * G +
               (ok ? r % G : 0)) * D + c * 8;
    cp_async16(q_s + swz<D>(r, c), src, ok);
  }
  cp_async_commit();

  // the chunk's block-table entries, once
  const int pg0 = key_begin / p.bs;
  const int npg = (key_end - 1) / p.bs - pg0 + 1;
  const int* btab = p.bt + (size_t)b * p.W + pg0;
  for (int i = tid; i < npg; i += NT) pages_s[i] = btab[i];
  __syncthreads();

  const size_t tok = (size_t)p.KVH * D;
  const size_t layer_off =
      (size_t)p.layer * p.N * p.bs * tok + (size_t)kvh * D;
  const __nv_bfloat16* kl = static_cast<const __nv_bfloat16*>(p.kc) + layer_off;
  const __nv_bfloat16* vl = static_cast<const __nv_bfloat16*>(p.vc) + layer_off;
  const uint8_t* kl8 = static_cast<const uint8_t*>(p.kc) + layer_off;
  const uint8_t* vl8 = static_cast<const uint8_t*>(p.vc) + layer_off;
  const int t_first = key_begin / kKeys * kKeys;
  const int nt = (key_end - t_first + kKeys - 1) / kKeys;

  // tile it into ring stage `stage`; keys outside [key_begin, key_end)
  // are zero-filled and never read
  auto load_tile = [&](int it, int stage) {
    const int t0 = t_first + it * kKeys;
    if constexpr (kFp8) {  // 16 e4m3 a copy, rows unswizzled
#pragma unroll
      for (int j = 0; j < kKeys * CH8 / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / CH8, c = i % CH8;
        const int pos = t0 + r;
        const bool ok = pos >= key_begin && pos < key_end;
        size_t off = 0;
        if (ok) {
          const int page = pos / p.bs;
          off = ((size_t)pages_s[page - pg0] * p.bs + (pos - page * p.bs)) *
                    tok + c * 16;
        }
        const uint32_t dst = stage * kTile8 + r * D + c * 16;
        cp_async16(k8_s + dst, kl8 + off, ok);
        cp_async16(v8_s + dst, vl8 + off, ok);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kKeys * CH / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / CH, c = i % CH;
      const int pos = t0 + r;
      const bool ok = pos >= key_begin && pos < key_end;
      size_t off = 0;
      if (ok) {
        const int page = pos / p.bs;
        off = ((size_t)pages_s[page - pg0] * p.bs + (pos - page * p.bs)) *
                  tok + c * 8;
      }
      cp_async16(k_s + stage * kTile + swz<D>(r, c), kl + off, ok);
      cp_async16(v_s + stage * kTile + swz<D>(r, c), vl + off, ok);
    }
  };

  // (kFp8) e4m3 stage `stage` -> the bf16 K and V tiles: e4m3 chunk c of
  // row r is bf16 chunks 2c and 2c + 1, at their swizzled places
  auto upcast_tile = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kKeys * CH8 / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / CH8, c = i % CH8;
      const uint32_t src = stage * kTile8 + r * D + c * 16;
      kv_fp8::upcast16(sm(k8_s + src), sm(k_s + swz<D>(r, 2 * c)),
                       sm(k_s + swz<D>(r, 2 * c + 1)));
      kv_fp8::upcast16(sm(v8_s + src), sm(v_s + swz<D>(r, 2 * c)),
                       sm(v_s + swz<D>(r, 2 * c + 1)));
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_tile(st, st);
    cp_async_commit();
  }

  // Q's A fragments for the warp's row tile: held across the walk up to
  // head_dim 128, read from shared memory at each k-step at 256
  cp_async_wait<kStages - 1>();
  __syncthreads();
  auto q_frag = [&](uint32_t(&r)[4], int kk) {
    ldsm_x4(r, q_s + swz<D>(rt * 16 + (lane & 15), kk * 2 + (lane >> 4)));
  };
  uint32_t qa[kHoldQ ? D / 16 : 1][4];
  if (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < (kHoldQ ? D / 16 : 0); ++kk) q_frag(qa[kk], kk);
  }

  // this thread's rows rt * 16 + g4 + 8 i: their visible key bounds
  int hi[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = (rt * 16 + g4 + 8 * i) / G;
    hi[i] = base + s;
    lo[i] = base + s - p.window + 1;
  }
  const int hi_min = base, lo_max = base + S - p.window;  // over the rows
  // capped scores are already in the log2 domain (see the note above)
  const float sl2 = kCap ? 1.f : p.scale * kLog2e;
  const float cap_in = kCap ? p.scale / p.softcap : 0.f;
  const float cap_l2 = p.softcap * kLog2e;

  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it landed
    __syncthreads();               // everyone's; the oldest stage is free
    {
      const int nx = it + kStages - 1;
      if (nx < nt) load_tile(nx, nx % kStages);
      cp_async_commit();
    }
    if constexpr (kFp8) {
      upcast_tile(it % kStages);  // the barrier above freed the bf16 tiles
      __syncthreads();            // ... and this one publishes them
    }
    const int stage = kFp8 ? 0 : it % kStages;
    const uint32_t kb = k_s + stage * kTile;
    const uint32_t vb = v_s + stage * kTile;
    const int t0 = t_first + it * kKeys;
    const int kw0 = kg * KW;  // the warp's first key in the tile

    // S = Q K^T over the warp's KW keys: K's rows are keys (K-major), so
    // ldmatrix without transpose gives the col-major B fragments of two
    // 8-key tiles at once
    float sc[NTL][4];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int qi = kHoldQ ? kk : 0;
      if (!kHoldQ) q_frag(qa[0], kk);
#pragma unroll
      for (int np = 0; np < NTL / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, kb + swz<D>(kw0 + np * 16 + (lane >> 4) * 8 + (lane & 7),
                                kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], qa[qi], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qa[qi], kf[2], kf[3]);
      }
    }
    if (kCap) {  // before the mask: a masked key stays -inf
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = cap_l2 * tanh_ex2(sc[n][e] * cap_in);
    }

    const bool need_mask = t0 < key_begin || t0 + kKeys > key_end ||
                           t0 + kKeys - 1 > hi_min || t0 < lo_max;
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = t0 + kw0 + n * 8 + t4 * 2 + (e & 1);
          const int i = e >> 1;
          if (!(j >= key_begin && j < key_end && j <= hi[i] && j >= lo[i]))
            sc[n][e] = -INFINITY;
        }
    }

    // online softmax in the log2 domain; the row max over the 4 lanes
    // that share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NTL; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * sl2);
      // a row with no visible key yet keeps p = 0 (no -inf - -inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          sc[n][e] = ex2(fmaf(sc[n][e], sl2, -m_use));
          sum += sc[n][e];
        }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[t][2 * i] *= alpha;
        o[t][2 * i + 1] *= alpha;
      }
    }

    // O += P V: the accumulators of two 8-key tiles are the A fragment of
    // one 16-key step; V's rows are keys, so ldmatrix .trans gives its B
    // fragments for two 8-column output tiles at once
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vb + swz<D>(kw0 + kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8,
                                  dp * 2 + (lane >> 4)));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // the warps' (m, l, acc) into shared memory over the K ring, then one
  // pass merges the key groups of each row
  __syncthreads();  // every warp is done with the ring
  float* dump_o = reinterpret_cast<float*>(smem + (k_s - q_s));  // [WK][ROWS][DS]
  float* dump_m = dump_o + WK * ROWS * DS;                       // [WK][ROWS]
  float* dump_l = dump_m + WK * ROWS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt * 16 + g4 + 8 * i;
    float* orow = dump_o + (kg * ROWS + r) * DS + t4 * 2;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<float2*>(orow + t * 8) =
          make_float2(o[t][2 * i], o[t][2 * i + 1]);
    if (t4 == 0) {
      dump_m[kg * ROWS + r] = m[i];
      dump_l[kg * ROWS + r] = l[i];
    }
  }
  __syncthreads();

  // (b, part, kvh)'s counter and first split
  const size_t row_id = (size_t)b * gridDim.y + blockIdx.y;
  const size_t part = row_id * nsplit;
  float* ws_o = p.ws + (part + split) * RS * D;  // [RS][D]
  float2* ws_ml = reinterpret_cast<float2*>(
      p.ws + (size_t)gridDim.z * gridDim.y * nsplit * RS * D);  // [.., nsplit, RS]
  for (int i = tid; i < R * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < WK; ++k) mx = fmaxf(mx, dump_m[k * ROWS + r]);
    float ls = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      const float mk = dump_m[k * ROWS + r];
      const float w = mk == -INFINITY ? 0.f : ex2(mk - mx);
      ls += w * dump_l[k * ROWS + r];
      const float4 ov =
          *reinterpret_cast<const float4*>(dump_o + (k * ROWS + r) * DS + c);
      acc[0] += w * ov.x;
      acc[1] += w * ov.y;
      acc[2] += w * ov.z;
      acc[3] += w * ov.w;
    }
    if (nlive == 1) {
      // the sink's term: the row rescaled to the shift max(mx, sink)
      const float sk = sink_l2(p, kvh * G + r % G);
      const float sh = fmaxf(mx, sk);
      const float w = p.sinks ? ex2_from(mx, sh) : 1.f;
      ls = ls * w + ex2_from(sk, sh);
      const float inv = ls > 0.f ? w / ls : 0.f;
      store_bf16x4(out_row(r) + c, acc[0] * inv, acc[1] * inv, acc[2] * inv,
                   acc[3] * inv);
    } else {
      *reinterpret_cast<float4*>(ws_o + (size_t)r * D + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (c == 0) ws_ml[(part + split) * RS + r] = make_float2(mx, ls);
    }
  }
  if (nlive == 1) return;

  // the last live split of this (row, KV head) to finish merges them all
  __threadfence();  // this CTA's partials are visible device-wide ...
  __syncthreads();  // ... before its thread 0 counts it
  if (tid == 0) {
    const int done = atomicAdd(p.cnt + row_id, 1);
    flag_s[0] = done == nlive - 1;
  }
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();

  // per row: the shift (the max over the splits and the sink) and 1 / l,
  // in split order
  float* row_m = stat_s;
  float* row_inv = stat_s + kMaxRows;
  for (int r = tid; r < R; r += NT) {
    const float sk = sink_l2(p, kvh * G + r % G);
    float mx = sk;
    for (int sp = sp_lo; sp <= sp_hi; ++sp)
      mx = fmaxf(mx, __ldcg(&ws_ml[(part + sp) * RS + r]).x);
    float ls = ex2_from(sk, mx);
    for (int sp = sp_lo; sp <= sp_hi; ++sp) {
      const float2 ml = __ldcg(&ws_ml[(part + sp) * RS + r]);
      ls += ex2_from(ml.x, mx) * ml.y;
    }
    row_m[r] = mx;
    row_inv[r] = ls > 0.f ? 1.f / ls : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < R * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float mx = row_m[r];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = sp_lo; sp <= sp_hi; ++sp) {
      const float ms = __ldcg(&ws_ml[(part + sp) * RS + r]).x;
      if (ms == -INFINITY) continue;
      const float w = ex2(ms - mx);
      const float4 ov = __ldcg(reinterpret_cast<const float4*>(
          p.ws + ((part + sp) * RS + r) * D + c));
      acc[0] += w * ov.x;
      acc[1] += w * ov.y;
      acc[2] += w * ov.z;
      acc[3] += w * ov.w;
    }
    const float inv = row_inv[r];
    store_bf16x4(out_row(r) + c, acc[0] * inv, acc[1] * inv, acc[2] * inv,
                 acc[3] * inv);
  }
  if (tid == 0) p.cnt[row_id] = 0;  // ready for the next call
}

// --------------------------------------------------------------- launch

// cudaFuncSetAttribute when this launch needs more dynamic shared memory
// than the function was last allowed on this device (the attribute belongs
// to the device's context), not on every launch
inline cudaError_t allow_smem(const void* fn, int bytes,
                              std::atomic<int> (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) {
    int cur = allowed[dev].load(std::memory_order_acquire);
    while (cur < bytes && !allowed[dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

template <int D, int M, bool kCap, bool kFp8>
cudaError_t launch(const Params& p, int B, int nsplit, cudaStream_t stream) {
  static_assert(ring_bytes<D, kFp8>() >=
                    key_groups(M) * 16 * M * ((D + 4) * 4 + 8),
                "the warps' dump must fit over the ring");
  static std::atomic<int> allowed[64];
  const size_t bytes = smem_bytes<D, M, kFp8>(p.chunk, p.bs);
  if (bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const int smem = (int)bytes;
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(splitkv_kernel<D, M, kCap, kFp8>), smem,
      allowed);
  if (err != cudaSuccess) return err;
  const int parts = (p.S + p.Sq - 1) / p.Sq;
  splitkv_kernel<D, M, kCap, kFp8><<<dim3(nsplit, parts * p.KVH, B),
                                     dim3(cta_threads(M)), smem, stream>>>(p);
  return cudaGetLastError();
}

// the softcap and cache-type forms of (D, row tiles)
template <int D, int M>
cudaError_t launch_form(const Params& p, int B, int nsplit, bool fp8,
                        cudaStream_t stream) {
  const bool cap = p.softcap > 0.f;
  if (fp8)
    return cap ? launch<D, M, true, true>(p, B, nsplit, stream)
               : launch<D, M, false, true>(p, B, nsplit, stream);
  return cap ? launch<D, M, true, false>(p, B, nsplit, stream)
             : launch<D, M, false, false>(p, B, nsplit, stream);
}

// Checks what the kernel assumes and launches the instantiation for
// (D, row tiles, softcap, e4m3 or bf16 caches). Returns cudaGetLastError()
// after the launch.
inline int launch_any(const Params& p, int B, int D, int nsplit, bool fp8,
                      cudaStream_t stream) {
  const int rows = p.Sq * p.G;
  if (B <= 0 || p.S <= 0 || p.Sq <= 0 || p.Sq > p.S || p.G <= 0 ||
      rows > max_rows(D) || p.chunk <= 0 ||
      p.chunk % kKeys || p.bs <= 0 || nsplit <= 0 ||
      (long long)nsplit * p.chunk < (long long)p.W * p.bs ||
      (nsplit > 1 && (p.ws == nullptr || p.cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int m = rows <= 16 ? 1 : rows <= 32 ? 2 : rows <= 64 ? 4 : 8;
#define SPLITKV_CASE(DD, MM) \
  if (D == DD && m == MM)    \
    return (int)launch_form<DD, MM>(p, B, nsplit, fp8, stream);
  SPLITKV_CASE(64, 1) SPLITKV_CASE(64, 2) SPLITKV_CASE(64, 4)
  SPLITKV_CASE(64, 8) SPLITKV_CASE(128, 1) SPLITKV_CASE(128, 2)
  SPLITKV_CASE(128, 4) SPLITKV_CASE(128, 8) SPLITKV_CASE(256, 1)
#undef SPLITKV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paged_splitkv
