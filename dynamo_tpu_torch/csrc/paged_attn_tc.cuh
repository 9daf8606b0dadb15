// The tensor-core tile loop shared by the two prefill attention kernels:
// csrc/paged_flash.cu (causal prefill over the paged cache, TPU kernel
// dynamo_tpu/ops/pallas_attention.py::paged_flash_attention) and
// csrc/sp_prefix.cu (unnormalised partials against the committed prefix,
// dynamo_tpu/ops/pallas_sp.py::paged_prefix_attention_partials).
//
// A CTA is kWG warpgroups (128 threads, 4 warps each) over 64 * kWG rows
// of (query position, group head) pairs of one (batch row, KV head):
// floor(64 * kWG / G) whole query positions times the G query heads that
// share the KV head, so every K/V tile staged in shared memory feeds all G
// heads (and every warpgroup). Any G up to 64 * kWG: when G does not
// divide the rows (Qwen2.5-7B's G 7: 9 positions, 63 rows and one spare in
// a flash CTA; 18 positions and 2 spare in a two-warpgroup CTA), the spare
// rows at the end load zeros for Q and the kernels store nothing of them
// (their query index lies past the CTA's positions). Warp w owns rows
// 16w .. 16w + 15; each warpgroup runs its own products on its 64 rows.
//
// Loads. Q (64 * kWG rows x D) and the K and V tiles (64 keys x D) are
// copied into shared memory by cp.async, 16 bytes a thread, into a ring of
// kStages stages: the copies of the next tiles are in flight while this
// tile's products run, and one __syncthreads a tile both publishes the
// landed tile and frees the stage read in the previous one. A tile of 64
// keys spans 64 / bs pages; each warp reads the tile's block-table entries
// once (a lane a page) and hands them to the copying lanes by shuffle.
// Shared memory holds each 64-column half of a row as one 128-byte line
// with its 16-byte chunks XOR-swizzled by (row % 8): the canonical
// 128-byte swizzle that wgmma descriptors read.
//
// Products. S = Q K^T and O += P V run on the tensor cores as warpgroup
// MMAs (wgmma.mma_async, bf16 in, f32 accumulators in registers). Q K^T:
// one m64n64k16 a 16-column k-step, Q and K from shared memory by
// descriptor (both K-major). (Q's fragments held in registers across the
// walk came back corrupted from the card once P V was a register-A wgmma
// too: the registers of two of them were handed to P's fragments.)
// P V: one m64nDk16 a 16-key step, P from registers straight from the
// score accumulators (the accumulator of two 8-key tiles is the A
// fragment of one 16-key step), V from the stage by descriptor with the
// transpose bit (its rows are keys, so it is N-major). Both Pallas kernels
// compute Q K^T in bf16 with f32 accumulation and round P to the value
// dtype before P V, so this is the reference's own arithmetic. kSplitP
// instead feeds P as bf16 hi + bf16 lo (two products), which keeps P to
// ~16 bits: the partials kernel uses it so its output stays within 1e-3 of
// the f32 plain version's scale, which a single bf16 rounding of P does
// not. Each product is committed and waited for before its accumulators
// are read.
//
// Softmax. Online softmax in the log2 domain on the accumulator
// fragments: a thread holds 2 rows x 16 keys of a tile; the row max
// reduces over the 4 lanes that share a row with two shuffles, and each
// lane keeps a partial row sum (l), summed over the 4 lanes once at the
// end. l is taken in f32 before P is rounded, as the reference does. Only
// tiles that need it are masked: the causal diagonal, the window's first
// tile and the tail of the key range. A softcap (Gemma-2; 0 = off) turns
// each raw score into cap * tanh(scale * q.k / cap) times log2 e before
// the mask, so a masked key stays -inf (pallas_attention.py:109-110), and
// the softmax then takes the tile with a factor of 1; tanh is
// 1 - 2 / (2^(2 x log2 e) + 1) on ex2.approx, as in paged_splitkv.cuh.
//
// head_dim 256 (Gemma-2-9b): Q K^T is 16 k-steps, and P V is two
// m64n128k16 products a 16-key step, one a 128-column half of V and of
// the accumulator. One warpgroup then holds 64 x 256 f32 in registers
// (128 a thread) beside 64 keys of scores: ptxas keeps a few
// loop-invariant values on the stack (4 bytes without the cap, 8 with it,
// reloaded once a 64-key tile), and the variants that spill nothing
// (32-key sub-steps, with or without descriptors built by offset) ran
// 10-25% slower on an H100 (PERF.md). It takes (64 + 6 * 64) * 512 +
// 1,024 = 230,400 bytes of shared memory, within the card's 232,448; two
// warpgroups (sp_prefix.cu) would not fit, so the partials kernel stays at
// 64 and 128. The softcap is a template argument (kCap): the walk without
// it is the one it was before.
//
// What bounds these kernels on an H100: operations for a long chunk (every
// staged K/V tile is reused by 64 * kWG rows). A warpgroup does not
// overlap a tile's softmax with its own products (a software-pipelined
// walk, Q K^T of tile j + 1 in flight during tile j's softmax, made ptxas
// serialise every wgmma and ran slower); the overlap comes from the other
// warpgroups and CTAs on the SM. See PERF.md for the measured share of the
// bound.
//
// head_dim 96 (Phi-3-mini; the flash kernel only). A row's second 64-column
// half is 32 columns: each tile keeps it as a full 128-byte line (D 128's
// footprint), of which the copies write chunks 0-3 (before the swizzle)
// and no copy reads past column 95 of the cache, so the descriptors and
// `swz` are those of D 128. Q K^T is 6 k-steps of m64n64k16 (the last two
// in the second half); P V is m64n64k16 on V's columns 0-63 plus m64n32k16
// on 64-95, each with its own descriptor, as D 256 does with two
// m64n128k16. 115,712 bytes of shared memory, as at 128.
//
// fp8 caches (kFp8; e4m3 K and V; the flash kernel's fp8 form). The ring
// holds kStages e4m3 tiles of K and of V beside one bf16 K and one bf16 V
// tile: after the barrier that publishes tile it, every thread upcasts
// its 16-byte e4m3 chunks into the bf16 tiles at the 128-byte-swizzled
// places the bf16 ring would hold them (csrc/kv_fp8.cuh), fences the
// generic-proxy writes for wgmma (fence.proxy.async) and a second barrier
// publishes them. The products read the same bf16 tile as the bf16 form
// does, so the result is bit for bit the bf16 form's over the cache upcast
// to bf16. At head_dim 256: 32 KB of Q, 64 KB of bf16 tiles and 96 KB of
// e4m3 ring, 197,632 bytes with the alignment (the bf16 form's 230,400).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "kv_fp8.cuh"

namespace paged_attn_tc {

constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 3;     // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A CTA of kWG warpgroups: 64 (query position, group head) rows and 128
// threads each; the warpgroups share every K/V stage
template <int kWG>
__host__ __device__ constexpr int cta_rows() {
  return 64 * kWG;
}
template <int kWG>
__host__ __device__ constexpr int cta_threads() {
  return 128 * kWG;
}

// the columns a bf16 row takes in shared memory: whole 64-column halves of
// 128-byte lines (96 -> 128; 64, 128 and 256 as they are)
template <int D>
__host__ __device__ constexpr int pitch() {
  return (D + 63) / 64 * 64;
}

// Q, then kStages K tiles, then kStages V tiles; +1 KB to align the base.
// kFp8: Q, one bf16 K and one bf16 V tile, then kStages e4m3 K tiles and
// kStages e4m3 V tiles (e4m3 rows unpadded)
template <int D, int kWG, bool kFp8 = false>
__host__ __device__ constexpr int smem_bytes() {
  return kFp8 ? (cta_rows<kWG>() + 2 * kKeys) * pitch<D>() * 2 +
                    2 * kStages * kKeys * D + 1024
              : (cta_rows<kWG>() + 2 * kStages * kKeys) * pitch<D>() * 2 +
                    1024;
}

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

// wgmma: the warpgroup's fence, commit and wait, and the compiler-side
// fence that keeps reads of an accumulator after the wait that ends it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int T>
__device__ __forceinline__ void fence_regs(float (&d)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[t][e])::"memory");
}
// cp.async (generic proxy) writes, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define WG_D4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d (64 x 64, f32) += A (64 x 16 bf16) * B (16 x 64 bf16), both K-major in
// shared memory via their descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6),
        WG_D4(7)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N, f32) += a (64 x 16 bf16, registers: the mma.m16n8k16 A
// fragment of each warp's 16 rows) * B (16 x N bf16, shared memory via
// desc; kTransB 0: K-major, 1: N-major). N = 64
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6),
        WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

// the same with N = 32
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

// the same with N = 128
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6),
        WG_D4(7), WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11), WG_D4(12),
        WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

#undef WG_D4

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

// two floats -> bf16x2 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x ~= hi + lo with hi, lo bf16: hi the rounded value, lo its residual
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// O (64 x D) += P (64 x 16, registers) * V's 16 rows at `vrow` of a stage
// (N-major: the transpose bit; its 64-column groups kKeys * 128 bytes
// apart): one m64nDk16 product at D 64 and 128; at 96 m64n64k16 on
// columns 0-63 and m64n32k16 on 64-95; two m64n128k16 at D 256; each on
// its part of the columns and of the accumulator
template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         uint32_t vrow) {
  if constexpr (D == 96) {
    wgmma_rs<1>(*reinterpret_cast<float(*)[8][4]>(&o[0]), a,
                desc_sw128(vrow, kKeys * 128, 1024));
    wgmma_rs<1>(*reinterpret_cast<float(*)[4][4]>(&o[8]), a,
                desc_sw128(vrow + kKeys * 128, kKeys * 128, 1024));
  } else if constexpr (D <= 128) {
    wgmma_rs<1>(o, a, desc_sw128(vrow, kKeys * 128, 1024));
  } else {
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
      wgmma_rs<1>(*reinterpret_cast<float(*)[16][4]>(&o[16 * h]), a,
                  desc_sw128(vrow + h * 2 * kKeys * 128, kKeys * 128, 1024));
  }
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of `rows`
// rows: each 64-column half of the tile is `rows` lines of 128 bytes,
// chunks XOR-swizzled by row % 8
__device__ __forceinline__ uint32_t swz(int row, int chunk, int rows) {
  return (uint32_t)((chunk >> 3) * (rows * 128) + row * 128 +
                    (((chunk & 7) ^ (row & 7)) << 4));
}

// --------------------------------------------------------------- the loop

// One CTA's problem: the query rows it owns and where its keys live (kc /
// vc bf16, or e4m3 in the fp8 form).
struct Problem {
  const __nv_bfloat16* q;   // [B, S, H, D]
  const void* kc;           // [L, N, bs, KVH, D]
  const void* vc;           // [L, N, bs, KVH, D]
  const int* btab;          // this batch row's block table
  int S, H, KVH, G, N, bs, layer;
  int b, kvh, s0;  // batch row, KV head, first query index of the CTA
  float scale;
  float softcap;   // 0: off
};

// What a thread holds after the loop: rows r0 = 16 * warp + lane / 4 and
// r0 + 8 (index i), output columns 8 * t + 2 * (lane % 4) + {0, 1} of
// o[t][2 i], o[t][2 i + 1]; m in the log2 domain (-inf: no key seen); l
// summed over the 4 lanes of the row.
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2];
  float l[2];
};

// Walks keys [key_begin, key_end) of layer p.layer in 64-key tiles from
// key_begin rounded down to a tile. kCausal: row r (query index s = p.s0 +
// r / G, position base + s) sees key j iff j <= base + s and j > base + s -
// window; otherwise every key of the range counts. Keys past key_end are
// zero-filled and masked.
template <int D, int kWG, bool kCausal, bool kSplitP, bool kCap = false,
          bool kFp8 = false>
__device__ __forceinline__ void attend(const Problem& p, int base, int window,
                                       int key_begin, int key_end,
                                       unsigned char* smem_raw,
                                       RowState<D>& st) {
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int DT = D / 8;    // 8-column output tiles
  constexpr uint32_t kTile = kKeys * pitch<D>() * 2;
  constexpr uint32_t kTile8 = kKeys * D;     // an e4m3 tile
  constexpr int CH8 = D / 16;                // 16-byte chunks per e4m3 row
  constexpr int kBufs = kFp8 ? 1 : kStages;  // bf16 K (and V) tiles
  constexpr int kRows = cta_rows<kWG>(), kThreads = cta_threads<kWG>();
  // every thread makes the same number of a tile's 16-byte copies
  static_assert(kKeys * CH % kThreads == 0 && kKeys * CH8 % kThreads == 0,
                "a tile's copies must divide among the CTA's threads");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, t4 = lane & 3;

#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[t][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
  }

  const int t_first = key_begin / kKeys * kKeys;
  const int nt = key_end > t_first ? (key_end - t_first + kKeys - 1) / kKeys
                                   : 0;
  if (nt == 0) return;

  const uint32_t base_s = smem_u32(smem_raw);
  const uint32_t q_s = (base_s + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kRows * pitch<D>() * 2;
  const uint32_t v_s = k_s + kBufs * kTile;
  const uint32_t k8_s = v_s + kBufs * kTile;  // the e4m3 rings (kFp8)
  const uint32_t v8_s = k8_s + kStages * kTile8;
  auto sm = [&](uint32_t a) { return smem_raw + (a - base_s); };

  // Q: row r is (query s0 + r / G, head kvh * G + r % G); zeros past S
  // and in the spare rows past the CTA's whole positions
  const int q_rows = kRows / p.G * p.G;
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int s = p.s0 + r / p.G;
    const bool ok = r < q_rows && s < p.S;
    const __nv_bfloat16* src =
        p.q + (((size_t)p.b * p.S + (ok ? s : 0)) * p.H + p.kvh * p.G +
               r % p.G) * D + c * 8;
    cp_async16(q_s + swz(r, c, kRows), src, ok);
  }

  const size_t tok = (size_t)p.KVH * D;
  const size_t layer_off =
      (size_t)p.layer * p.N * p.bs * tok + (size_t)p.kvh * D;
  const __nv_bfloat16* kl = static_cast<const __nv_bfloat16*>(p.kc) + layer_off;
  const __nv_bfloat16* vl = static_cast<const __nv_bfloat16*>(p.vc) + layer_off;
  const uint8_t* kl8 = static_cast<const uint8_t*>(p.kc) + layer_off;
  const uint8_t* vl8 = static_cast<const uint8_t*>(p.vc) + layer_off;

  auto load_tile = [&](int it, int stage) {
    const int t0 = t_first + it * kKeys;
    const int pg0 = t0 / p.bs;
    const int npg = (min(t0 + kKeys, key_end) - 1) / p.bs - pg0 + 1;
    // a lane a page: the tile's block-table entries, read once per warp
    const int mine = lane < npg ? p.btab[pg0 + lane] : 0;
    if constexpr (kFp8) {  // 16 e4m3 a copy, rows unswizzled
#pragma unroll
      for (int j = 0; j < kKeys * CH8 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / CH8, c = i % CH8;
        const int pos = t0 + r;
        const bool ok = pos < key_end;
        const int page = pos / p.bs;
        int blk = __shfl_sync(0xffffffffu, mine, (page - pg0) & 31);
        if (ok && page - pg0 >= 32) blk = p.btab[page];  // bs < 2 only
        const size_t off =
            ok ? ((size_t)blk * p.bs + (pos - page * p.bs)) * tok + c * 16 : 0;
        const uint32_t dst = stage * kTile8 + r * D + c * 16;
        cp_async16(k8_s + dst, kl8 + off, ok);
        cp_async16(v8_s + dst, vl8 + off, ok);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kKeys * CH / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / CH, c = i % CH;
      const int pos = t0 + r;
      const bool ok = pos < key_end;
      const int page = pos / p.bs;
      int blk = __shfl_sync(0xffffffffu, mine, (page - pg0) & 31);
      if (ok && page - pg0 >= 32) blk = p.btab[page];  // bs < 2 only
      const size_t off =
          ok ? ((size_t)blk * p.bs + (pos - page * p.bs)) * tok + c * 8 : 0;
      cp_async16(k_s + stage * kTile + swz(r, c, kKeys), kl + off, ok);
      cp_async16(v_s + stage * kTile + swz(r, c, kKeys), vl + off, ok);
    }
  };

  // (kFp8) e4m3 stage `stage` -> the bf16 K and V tiles: e4m3 chunk c of
  // row r is bf16 chunks 2c and 2c + 1, at their swizzled places
  auto upcast_tile = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kKeys * CH8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / CH8, c = i % CH8;
      const uint32_t src = stage * kTile8 + r * D + c * 16;
      kv_fp8::upcast16(sm(k8_s + src), sm(k_s + swz(r, 2 * c, kKeys)),
                       sm(k_s + swz(r, 2 * c + 1, kKeys)));
      kv_fp8::upcast16(sm(v8_s + src), sm(v_s + swz(r, 2 * c, kKeys)),
                       sm(v_s + swz(r, 2 * c + 1, kKeys)));
    }
  };

#pragma unroll
  for (int st0 = 0; st0 < kStages - 1; ++st0) {
    if (st0 < nt) load_tile(st0, st0);
    cp_async_commit();  // Q rides in the first group
  }

  // the masking bounds: per row, and for the CTA (is a tile all visible?)
  const int row0 = warp * 16 + quad;
  int hi[2] = {INT_MAX, INT_MAX}, lo[2] = {INT_MIN, INT_MIN};
  int hi_min = INT_MAX, lo_max = INT_MIN;
  if (kCausal) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hi[i] = base + p.s0 + (row0 + 8 * i) / p.G;
      lo[i] = hi[i] - window + 1;
    }
    const int s_last = min(p.s0 + kRows / p.G, p.S) - 1;
    hi_min = base + p.s0;
    lo_max = base + s_last - window + 1;
  }
  // capped scores are already in the log2 domain; kCap is a template
  // argument, so the walk without a cap is the one it was before
  const float sl2 = kCap ? 1.f : p.scale * kLog2e;
  const float cap_in = kCap ? p.scale / p.softcap : 0.f;
  const float cap_l2 = p.softcap * kLog2e;

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it landed
    fence_proxy_async();           // ... and visible to wgmma
    __syncthreads();               // everyone's; the oldest stage is free
    {
      const int nx = it + kStages - 1;
      if (nx < nt) load_tile(nx, nx % kStages);
      cp_async_commit();
    }
    if constexpr (kFp8) {
      // every warpgroup's products of tile it - 1 were waited for before
      // the barrier above, so the bf16 tiles are free
      upcast_tile(it % kStages);
      fence_proxy_async();  // the generic-proxy writes, visible to wgmma
      __syncthreads();
    }
    const int stage = kFp8 ? 0 : it % kStages;
    const uint32_t kb = k_s + stage * kTile;
    const uint32_t vb = v_s + stage * kTile;
    const int t0 = t_first + it * kKeys;

    // S = Q K^T: the warpgroup's 64 rows x 64 keys, one m64n64k16 a
    // 16-column k-step with Q and K (both K-major) from shared memory; a
    // warp's 16 rows come back as 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // k-step kk: 32 bytes into the 128-byte lines of 64-column half kk / 4
      const uint32_t koff = (kk & 3) * 32;
      wgmma_ss(sc,
               desc_sw128(q_s + (kk >> 2) * (kRows * 128) +
                              (warp >> 2) * (64 * 128) + koff,
                          16, 1024),
               desc_sw128(kb + (kk >> 2) * (kKeys * 128) + koff, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (kCap) {  // before the mask: a masked key stays -inf
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = cap_l2 * tanh_ex2(sc[n][e] * cap_in);
    }

    const bool need_mask =
        t0 + kKeys > key_end ||
        (kCausal && (t0 + kKeys - 1 > hi_min || t0 < lo_max));
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = t0 + n * 8 + t4 * 2 + (e & 1);
          const int i = e >> 1;
          if (!(j < key_end && j <= hi[i] && j >= lo[i])) sc[n][e] = -INFINITY;
        }
    }

    // online softmax in the log2 domain
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(st.m[i], mx * sl2);
      // a row with no visible key yet keeps p = 0 (no -inf - -inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(st.m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          sc[n][e] = ex2(fmaf(sc[n][e], sl2, -m_use));
          sum += sc[n][e];
        }
      st.l[i] = st.l[i] * alpha + sum;
      st.m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        st.o[t][2 * i] *= alpha;
        st.o[t][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P from the score fragments (the accumulator of two 8-key
    // tiles is the A fragment of one 16-key step), V (key-major rows, so
    // N-major: the transpose bit) from shared memory, one m64nDk16 a step
    uint32_t a[kKeys / 16][4], alo[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      if (kSplitP) {
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], a[kk][0], alo[kk][0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], a[kk][1], alo[kk][1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], a[kk][2], alo[kk][2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], a[kk][3], alo[kk][3]);
      } else {
        a[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        a[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        a[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
    }
    fence_regs(st.o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pv_wgmma<D>(st.o, a[kk], vb + kk * 16 * 128);
      if (kSplitP) pv_wgmma<D>(st.o, alo[kk], vb + kk * 16 * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st.o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }
}

// cudaFuncSetAttribute once per device and process (the attribute belongs
// to the device's context), not on every launch
inline cudaError_t allow_smem_once(const void* fn, int bytes,
                                   std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace paged_attn_tc
