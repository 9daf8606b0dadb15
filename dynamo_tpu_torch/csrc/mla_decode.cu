// DeepSeek MLA single-token (decode) attention over the stacked compressed
// latent cache, on the tensor cores, in one launch.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_decode.py
// (mla_paged_decode_attention / _mla_decode_kernel). It computes the same
// function: for batch row b and query head h,
//   score[t] = scale * (q_lat[h] . c[t] + q_rope[h] . kr[t])   for t < ctx[b]
//   out[h]   = sum_t softmax(score)[t] * c[t]                  (over R)
// walking the pages of block_tables[b] in layer `layer` of the stacked
// caches c [L, N, bs, 1, R] and kr [L, N, bs, 1, RD], with f32 accumulation;
// P is rounded to bf16 before P.c (the reference casts p_unn to c's dtype)
// and l is summed from the f32 P; a row with no key (ctx == 0) outputs
// zeros, never NaN; the output is bf16 [B, 1, H, R]. The caches are
// unpadded (the reference pads R and RD to 128 lanes for the TPU's DMA).
//
// What bounds it on an H100: bytes. One key is (R + RD) * 2 = 1,152 bytes
// at DeepSeek-V2/V3 widths, shared by every query head; the value is the
// latent itself. Each live key is read from device memory once per head
// group of 16 heads.
//
// Grid: (split, head group, batch row), from tensor shapes only. The block
// table's width W * bs is cut into chunks of `chunk` keys (128 from
// ops/mla_decode.py, two 64-key tiles), one CTA a chunk and a group of 16
// heads (H = 128 takes 8 groups; a ragged last group masks its rows).
// Consecutive splits form thread-block clusters of 8 CTAs. Neither size
// follows the width, so a row's splits and merge order, and so its output
// bits, are the same whatever width a caller pads its tables to (the K=1
// step and the decode bursts pad to different widths). Each CTA reads ctx on the device; a cluster wholly past it exits
// at once, so no host read of ctx is needed and a launch can be captured in
// a CUDA graph. The chunk's keys become a table of token rows in shared
// memory first (one division a key), so a 16-byte copy costs a shared load
// and an add.
//
// Inside a CTA (8 warps). The 16 heads are the M rows of one
// mma.sync.m16n8k16 tile: at 16 heads no row is idle. [c | kr] tiles of
// 64 keys x 576 stay bf16 in a ring of 3 cp.async stages (72 KB each,
// chunks XOR-swizzled by row % 8 so that ldmatrix reads them without bank
// conflicts); the next two tiles are in flight while this one computes. Q
// [16 x 576] is staged once in the third stage and held in registers as A
// fragments.
// - Scores S = Q [c | kr]^T. The warps split the 576-wide reduction in two
//   halves of 18 k-steps (Q's half, 72 registers, stays in registers for
//   the whole walk) and the tile's keys in four groups of 16; each warp
//   keeps two accumulator chains per 8-key tile, so no chain is longer than
//   9 dependent products. The two halves' partial scores meet through
//   shared memory: each warp hands its partner the 8-key tile the partner
//   finishes, so every warp ends with the full scores of 8 keys.
// - Online softmax (f32, log2 domain) on those fragments: the tile's row
//   max across the 8 warps through shared memory, P = exp2(s - m) written
//   to shared memory as bf16, each warp's own l.
// - O += P c with ldmatrix.trans on the same staged tile (c is the value,
//   so no byte is loaded twice); warp w owns latent columns 64w .. 64w + 63
//   of the f32 accumulator (32 registers).
//
// Merging the splits in the same launch, without one CTA reading every
// partial (a [16 x 512] f32 partial is 32 KB; one SM reads L2 at ~64 bytes
// a cycle). Each CTA leaves its unnormalised (m, l, acc) in its own shared
// memory, and after a cluster barrier CTA r of the cluster merges columns
// r * 512 / cs .. of all its peers' partials, in rank order, through
// distributed shared memory. A row whose keys fit one split skips all of
// it (its split writes the bf16 output, its cluster's other CTAs leave at
// once); a row whose keys fit one cluster writes the output after the
// DSMEM merge. Otherwise each cluster writes its merged (m, l, acc)
// slice to a workspace the wrapper keeps, and the last cluster of the (row,
// head group) to finish (a __threadfence, a cluster barrier and an int
// counter the wrapper keeps zeroed; rank 0 counts, resets it when last and
// tells its peers) merges every live cluster's partial in cluster order,
// each of its CTAs its own columns. No float atomics: two calls are
// bit-identical.
//
// fp8 caches (kFp8; c and kr both e4m3, mla_decode_fp8; the TPU kernel's
// fp8 specialization, pallas_decode.py:278-281). The 216 KB bf16 ring
// leaves no room for a second one, so the fp8 form keeps 3 e4m3 stages of
// [c | kr] (36 KB each, rows unswizzled) and ONE bf16 tile: after the
// barrier that publishes tile it, every thread upcasts its 16-byte e4m3
// chunks into the bf16 tile at the swizzled places the bf16 ring would
// hold them (csrc/kv_fp8.cuh), and a second barrier publishes it; Q is
// staged in that bf16 tile before the walk. The products read the same
// bf16 tile as the bf16 form, so the result is bit for bit the bf16
// form's over the caches upcast to bf16, from half the bytes.
//
// Limits: R == 512 and RD == 64 (DeepSeek-V2, V2-Lite and V3); c and kr
// both bf16 or both e4m3; Q and the output bf16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/mla_decode.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "kv_fp8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int R = 512;            // latent width
constexpr int RD = 64;            // rope width
constexpr int D = R + RD;         // key width (576)
constexpr int HG = 16;            // heads a CTA: one m16 row tile
constexpr int TK = 64;            // keys a tile
constexpr int STAGES = 3;         // cp.async ring depth
constexpr int NT = 256;           // 8 warps
constexpr int NW = NT / 32;
constexpr int CH = D / 8;         // 16-byte chunks a key row (72)
constexpr int KSTEPS = D / 16;    // k-steps of the score product (36)
constexpr int KHALF = KSTEPS / 2; // a warp's k-steps (18)
constexpr uint32_t ROW_BYTES = D * 2;            // 1,152
constexpr uint32_t TILE_BYTES = TK * ROW_BYTES;  // 73,728
constexpr uint32_t ROW8 = D;                     // an e4m3 key row (576)
constexpr uint32_t TILE8 = TK * ROW8;            // 36,864
constexpr int CH8 = D / 16;                      // 16-byte e4m3 chunks a row (36)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRank = R, kRopeDim = RD;  // for the C entry, whose R / RD are arguments

// dynamic shared memory: the ring (bf16: 3 stages, Q staged in the last
// before the walk; fp8: the bf16 tile, Q staged in it, then 3 e4m3
// stages; after the walk, the CTA's partial for the cluster merge), P
// [16 x 64] bf16, the score hand-over [4 key groups][2][32 lanes] float4,
// the row maxima and the l sums [8 warps][16], the last-cluster flag, then
// the chunk's token table (one int a key)
template <bool kFp8>
struct Layout {
  static constexpr int RING = kFp8 ? TILE_BYTES + STAGES * TILE8
                                   : STAGES * TILE_BYTES;
  static constexpr int OFF_P = RING;
  static constexpr int OFF_X = OFF_P + HG * TK * 2;
  static constexpr int OFF_RED = OFF_X + 4 * 2 * 32 * 16;
  static constexpr int OFF_LSUM = OFF_RED + NW * HG * 4;
  static constexpr int OFF_FLAG = OFF_LSUM + NW * HG * 4;
  static constexpr int OFF_TOK = OFF_FLAG + 16;
};
constexpr int MAX_SMEM = 232448;  // an H100 CTA's dynamic shared memory
constexpr int CL_MAX = 8;         // CTAs a cluster (portable)
constexpr int OS = R + 4;         // f32 row stride of a CTA's partial

static_assert(TK * (R / 8) % NT == 0 && TK * (RD / 8) % NT == 0,
              "a tile's copies split evenly");
static_assert(TK * (R / 16) % NT == 0 && TK * (RD / 16) % NT == 0 &&
                  TK * CH8 % NT == 0,
              "an e4m3 tile's copies and upcasts split evenly");
static_assert(HG * OS * 4 + HG * 8 <= Layout<true>::RING &&
                  HG * OS * 4 + HG * 8 <= Layout<false>::RING,
              "the partial fits the ring");

inline size_t smem_bytes(int chunk, bool fp8) {
  return (size_t)(fp8 ? Layout<true>::OFF_TOK : Layout<false>::OFF_TOK) +
         (size_t)chunk * 4;
}

// c and kr hold bf16, or e4m3 in the fp8 form
struct Params {
  const __nv_bfloat16* q_lat;   // [B, H, R]
  const __nv_bfloat16* q_rope;  // [B, H, RD]
  const void* c;                // [L, N, bs, R]
  const void* kr;               // [L, N, bs, RD]
  const int* bt;                // [B, W]
  const int* ctx_lens;          // [B]
  __nv_bfloat16* out;           // [B, H, R]
  float* ws;                    // [B, G, clusters, HG, R] acc, then (m, l)
  int* cnt;                     // [>= B * G] cluster counters, zero between calls
  int H, N, bs, W, layer, chunk;
  float scale;
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

// ---------------------------------------------------------------- helpers

// two floats -> bf16x2 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk `chunk` of key (or head) row `row` in a
// [rows x 576] bf16 tile: chunks XOR-swizzled by row % 8 within their
// group of 8, so the 8 rows an ldmatrix reads at one chunk index fall on 8
// distinct bank groups
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// the same for P [16 x 64] bf16 (8 chunks a row)
__device__ __forceinline__ uint32_t pswz(int row, int chunk) {
  return (uint32_t)(row * (TK * 2) + ((chunk ^ (row & 7)) << 4));
}

// ------------------------------------------------------------- the kernel

template <bool kFp8>
__global__ void __launch_bounds__(NT, 1) mla_decode_kernel(const Params p) {
  using LY = Layout<kFp8>;
  constexpr int OFF_P = LY::OFF_P, OFF_X = LY::OFF_X, OFF_RED = LY::OFF_RED;
  constexpr int OFF_LSUM = LY::OFF_LSUM, OFF_FLAG = LY::OFF_FLAG;
  constexpr int OFF_TOK = LY::OFF_TOK;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();

  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int ngrp = gridDim.y, ncl = gridDim.x / cs, clid = split / cs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int kg = warp & 3;   // key group: the tile's keys 16 kg .. 16 kg + 15
  const int dg = warp >> 2;  // score half: k-steps 18 dg .. 18 dg + 17
  const int h0 = grp * HG, hg = min(HG, p.H - h0);
  // keys past the table do not exist (the plain version masks arange(W bs))
  const int ctx = min(p.ctx_lens[b], p.W * p.bs);

  auto out_at = [&](int r, int col) {
    return p.out + ((size_t)b * p.H + h0 + r) * R + col;
  };

  if (ctx <= 0) {  // no key: split 0 writes zeros (every cluster leaves)
    if (split == 0)
      for (int i = tid; i < hg * (R / 8); i += NT)
        *reinterpret_cast<uint4*>(out_at(i / (R / 8), (i % (R / 8)) * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int nlive = (ctx - 1) / p.chunk + 1;      // splits holding keys
  const int ncl_live = (nlive - 1) / cs + 1;      // clusters holding them
  if (clid >= ncl_live) return;  // the whole cluster is past ctx
  if (nlive == 1 && split > 0) return;  // one split holds the row: no merge

  float4* x_s = reinterpret_cast<float4*>(smem + OFF_X);
  float* red_s = reinterpret_cast<float*>(smem + OFF_RED);
  float* lsum_s = reinterpret_cast<float*>(smem + OFF_LSUM);
  int* flag_s = reinterpret_cast<int*>(smem + OFF_FLAG);
  int* tok_s = reinterpret_cast<int*>(smem + OFF_TOK);

  // rows g4 and g4 + 8: the unnormalised output of this warp's 64 columns,
  // the running max (the same in every warp) and l; a split past ctx in a
  // live cluster keeps them empty
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, lt[2] = {0.f, 0.f};

  if (split < nlive) {
    const int key_begin = split * p.chunk;
    const int key_end = min(ctx, key_begin + p.chunk);
    const int nt = (key_end - key_begin + TK - 1) / TK;
    const uint32_t s0 = smem_u32(smem);
    // bf16: Q in the last stage (the walk's first loads fill the others);
    // fp8: Q in the bf16 tile, first overwritten after the loop's barrier
    const uint32_t q_s = kFp8 ? s0 : s0 + (STAGES - 1) * TILE_BYTES;
    const uint32_t r8_s = s0 + TILE_BYTES;  // the e4m3 ring (kFp8)
    const uint32_t p_s = s0 + OFF_P;

    // Q: the group's heads, [q_lat | q_rope], zeros past H
    for (int i = tid; i < HG * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < hg;
      const size_t row = (size_t)b * p.H + h0 + (ok ? r : 0);
      const __nv_bfloat16* src = c < R / 8 ? p.q_lat + row * R + c * 8
                                           : p.q_rope + row * RD + (c - R / 8) * 8;
      cp_async16(q_s + swz(r, c), src, ok);
    }
    cp_async_commit();

    // the chunk's keys as token rows of the layer: one division a key
    const size_t tok0 = (size_t)p.layer * p.N * p.bs;
    for (int i = tid; i < key_end - key_begin; i += NT) {
      const int pos = key_begin + i;
      const int page = pos / p.bs;
      tok_s[i] = p.bt[(size_t)b * p.W + page] * p.bs + (pos - page * p.bs);
    }
    __syncthreads();

    // tile `it` into ring stage `stage`: c as 64 chunks a key (thread t
    // takes chunk t % 64 of keys t / 64 + 4 j), kr as 8 (chunk t % 8 of keys
    // t / 8 + 32 j); keys at or past key_end are zeros
    auto load_tile = [&](int it, int stage) {
      const int r0 = it * TK;
      if constexpr (kFp8) {
        // e4m3 rows of [c | kr], unswizzled: c as 32 chunks a key (thread
        // t takes chunk t % 32 of keys t / 32 + 8 j), kr as 4 (chunk t % 4
        // of key t / 4)
        const uint32_t dst = r8_s + stage * TILE8;
        const uint8_t* c8 = static_cast<const uint8_t*>(p.c);
        const uint8_t* kr8 = static_cast<const uint8_t*>(p.kr);
#pragma unroll
        for (int j = 0; j < TK * (R / 16) / NT; ++j) {
          const int r = (tid >> 5) + j * (NT / 32), c = tid & 31;
          const bool ok = key_begin + r0 + r < key_end;
          const uint8_t* src = ok ? c8 + (tok0 + tok_s[r0 + r]) * R + c * 16 : c8;
          cp_async16(dst + r * ROW8 + c * 16, src, ok);
        }
#pragma unroll
        for (int j = 0; j < TK * (RD / 16) / NT; ++j) {
          const int r = (tid >> 2) + j * (NT / 4), c = tid & 3;
          const bool ok = key_begin + r0 + r < key_end;
          const uint8_t* src =
              ok ? kr8 + (tok0 + tok_s[r0 + r]) * RD + c * 16 : kr8;
          cp_async16(dst + r * ROW8 + R + c * 16, src, ok);
        }
        return;
      }
      const uint32_t dst = s0 + stage * TILE_BYTES;
      const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(p.c);
      const __nv_bfloat16* krb = static_cast<const __nv_bfloat16*>(p.kr);
#pragma unroll
      for (int j = 0; j < TK * (R / 8) / NT; ++j) {
        const int r = (tid >> 6) + j * (NT / 64), c = tid & 63;
        const bool ok = key_begin + r0 + r < key_end;
        const __nv_bfloat16* src =
            ok ? cb + (tok0 + tok_s[r0 + r]) * R + c * 8 : cb;
        cp_async16(dst + swz(r, c), src, ok);
      }
#pragma unroll
      for (int j = 0; j < TK * (RD / 8) / NT; ++j) {
        const int r = (tid >> 3) + j * (NT / 8), c = tid & 7;
        const bool ok = key_begin + r0 + r < key_end;
        const __nv_bfloat16* src =
            ok ? krb + (tok0 + tok_s[r0 + r]) * RD + c * 8 : krb;
        cp_async16(dst + swz(r, R / 8 + c), src, ok);
      }
    };

    // (kFp8) e4m3 stage `stage` -> the bf16 tile: e4m3 chunk cc of key r
    // (c's 32, then kr's 4) is bf16 chunks 2 cc and 2 cc + 1, at their
    // swizzled places
    auto upcast_tile = [&](int stage) {
#pragma unroll
      for (int j = 0; j < TK * CH8 / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / CH8, cc = i % CH8;
        kv_fp8::upcast16(smem + (r8_s - s0) + stage * TILE8 + r * ROW8 + cc * 16,
                         smem + swz(r, 2 * cc), smem + swz(r, 2 * cc + 1));
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nt) load_tile(st, st);
      cp_async_commit();
    }

    // Q's A fragments of this warp's half of the reduction, held across the
    // walk (the stage they sit in is refilled after the first barrier below)
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    uint32_t qa[KHALF][4];
#pragma unroll
    for (int j = 0; j < KHALF; ++j)
      ldsm_x4(qa[j], q_s + swz(lane & 15, 2 * (KHALF * dg + j) + (lane >> 4)));

    const float sl2 = p.scale * kLog2e;
    const int kmine = 16 * kg + 8 * dg;  // the 8 keys this warp finishes
    float l[2] = {0.f, 0.f};  // this warp's share of l

    for (int it = 0; it < nt; ++it) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile it landed
      __syncthreads();              // everyone's; the oldest stage is free
      {
        const int nx = it + STAGES - 1;
        if (nx < nt) load_tile(nx, nx % STAGES);
        cp_async_commit();
      }
      if constexpr (kFp8) {
        upcast_tile(it % STAGES);  // the barrier above freed the bf16 tile
        __syncthreads();           // ... and this one publishes it
      }
      const uint32_t kb = s0 + (kFp8 ? 0 : (it % STAGES) * TILE_BYTES);
      const int t0 = key_begin + it * TK;

      // partial scores: this warp's 18 k-steps against keys 16 kg .. +15
      // (two 8-key tiles), even and odd k-steps in separate chains
      float sc[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[a][n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KHALF; ++j) {
        uint32_t kf[4];
        ldsm_x4(kf, kb + swz(16 * kg + (lane >> 4) * 8 + (lane & 7),
                             2 * (KHALF * dg + j) + ((lane >> 3) & 1)));
        mma_bf16(sc[j & 1][0], qa[j], kf[0], kf[1]);
        mma_bf16(sc[j & 1][1], qa[j], kf[2], kf[3]);
      }
      // hand the partner warp (same keys, other half) the 8-key tile it
      // finishes; take the partner's half of ours
      float keep[4], give[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t0e = sc[0][0][e] + sc[1][0][e];
        const float t1e = sc[0][1][e] + sc[1][1][e];
        keep[e] = dg ? t1e : t0e;
        give[e] = dg ? t0e : t1e;
      }
      x_s[(kg * 2 + (1 - dg)) * 32 + lane] =
          make_float4(give[0], give[1], give[2], give[3]);
      __syncthreads();
      const float4 other = x_s[(kg * 2 + dg) * 32 + lane];
      float s[4] = {keep[0] + other.x, keep[1] + other.y, keep[2] + other.z,
                    keep[3] + other.w};

      // scale into the log2 domain, mask keys past the chunk; the row max
      // over this warp's 8 keys
      const bool edge = t0 + TK > key_end;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + kmine + 2 * t4 + (e & 1);
        s[e] = (!edge || j < key_end) ? s[e] * sl2 : -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(s[2 * i], s[2 * i + 1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t4 == 0) red_s[warp * HG + g4 + 8 * i] = mx;
      }
      __syncthreads();

      // the tile's row max over the warps (the tile's first key is live, so
      // it is finite), then P and this warp's l
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tm = red_s[g4 + 8 * i];
#pragma unroll
        for (int w = 1; w < NW; ++w) tm = fmaxf(tm, red_s[w * HG + g4 + 8 * i]);
        const float m_new = fmaxf(m[i], tm);
        const float alpha = ex2(m[i] - m_new);
        m[i] = m_new;
        s[2 * i] = ex2(s[2 * i] - m_new);
        s[2 * i + 1] = ex2(s[2 * i + 1] - m_new);
        l[i] = l[i] * alpha + s[2 * i] + s[2 * i + 1];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
      }
      {
        const int pc = 2 * kg + dg;  // P's chunk of this warp's keys
        *reinterpret_cast<uint32_t*>(smem + OFF_P + pswz(g4, pc) + 4 * t4) =
            pack_bf16(s[0], s[1]);
        *reinterpret_cast<uint32_t*>(smem + OFF_P + pswz(g4 + 8, pc) + 4 * t4) =
            pack_bf16(s[2], s[3]);
      }
      __syncthreads();

      // O += P c: P [16 x 64] is the A operand of four 16-key steps; c's rows
      // are keys, so ldmatrix .trans gives the B fragments of two 8-column
      // tiles of this warp's 64 columns at once
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t pa[4];
        ldsm_x4(pa, p_s + pswz(lane & 15, 2 * kk + (lane >> 4)));
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, kb + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 8 * warp + 2 * dp + (lane >> 4)));
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();

    // l over the 4 lanes of a row, then over the warps in warp order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (t4 == 0) lsum_s[warp * HG + g4 + 8 * i] = l[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) a += lsum_s[w * HG + g4 + 8 * i];
      lt[i] = a;
    }
  }

  if (nlive == 1) {  // the whole row in this split: normalise and store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g4 + 8 * i;
      if (r >= hg) continue;
      const float inv = 1.f / lt[i];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(out_at(r, 64 * warp + 8 * n + 2 * t4)) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    return;
  }

  // this CTA's partial (acc, m, l) into its shared memory, over the ring
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem);                  // [HG][OS]
  float2* ml_s = reinterpret_cast<float2*>(smem + HG * OS * 4);  // [HG]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g4 + 8 * i;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(o_s + r * OS + 64 * warp + 8 * n + 2 * t4) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
    if (warp == 0 && t4 == 0) ml_s[r] = make_float2(m[i], lt[i]);
  }
  cl.sync();  // every partial of the cluster is in place

  // CTA `rank` merges columns [rank, rank + 1) * 512 / cs of the cluster's
  // partials, in rank order, reading its peers' shared memory
  const int ncol4 = (R / 4) / cs;  // float4 columns a CTA merges
  const size_t part = ((size_t)b * ngrp + grp) * ncl;  // (b, grp)'s first cluster
  float* ws_o = p.ws;                                   // [.., ncl, HG, R]
  float2* ws_ml = reinterpret_cast<float2*>(
      p.ws + (size_t)gridDim.z * ngrp * ncl * HG * R);  // [.., ncl, HG]
  for (int i = tid; i < HG * ncol4; i += NT) {
    const int r = i / ncol4, c = (rank * ncol4 + i % ncol4) * 4;
    float2 mlq[CL_MAX];
    float4 oq[CL_MAX];
#pragma unroll
    for (int q = 0; q < CL_MAX; ++q) {
      if (q < cs) {
        mlq[q] = cl.map_shared_rank(ml_s, q)[r];
        oq[q] = *reinterpret_cast<const float4*>(cl.map_shared_rank(o_s, q) + r * OS + c);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < CL_MAX; ++q)
      if (q < cs) mx = fmaxf(mx, mlq[q].x);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < CL_MAX; ++q) {
      if (q < cs && mlq[q].x != -INFINITY) {
        const float w = ex2(mlq[q].x - mx);
        L += w * mlq[q].y;
        acc.x += w * oq[q].x;
        acc.y += w * oq[q].y;
        acc.z += w * oq[q].z;
        acc.w += w * oq[q].w;
      }
    }
    if (ncl_live == 1) {  // the whole row in this cluster: normalise and store
      if (r < hg) {
        const float inv = 1.f / L;
        uint2 pk;
        pk.x = pack_bf16(acc.x * inv, acc.y * inv);
        pk.y = pack_bf16(acc.z * inv, acc.w * inv);
        *reinterpret_cast<uint2*>(out_at(r, c)) = pk;
      }
    } else {
      *reinterpret_cast<float4*>(ws_o + ((part + clid) * HG + r) * R + c) = acc;
      if (rank == 0 && i % ncol4 == 0) ws_ml[(part + clid) * HG + r] = make_float2(mx, L);
    }
  }
  if (ncl_live == 1) {
    cl.sync();  // no CTA leaves while a peer may still read its shared memory
    return;
  }

  // the last live cluster of this (row, head group) to finish merges them
  __threadfence();  // this CTA's slice is visible device-wide ...
  cl.sync();        // ... and every peer's, before rank 0 counts the cluster
  if (rank == 0 && tid == 0) {
    const int done = atomicAdd(p.cnt + (size_t)b * ngrp + grp, 1);
    const int last = done == ncl_live - 1;
    if (last) p.cnt[(size_t)b * ngrp + grp] = 0;  // ready for the next call
    for (int q = 0; q < cs; ++q) *cl.map_shared_rank(flag_s, q) = last;
  }
  cl.sync();
  if (!flag_s[0]) return;
  __threadfence();
  for (int i = tid; i < HG * ncol4; i += NT) {
    const int r = i / ncol4, c = (rank * ncol4 + i % ncol4) * 4;
    if (r >= hg) continue;
    float mx = -INFINITY;
    for (int k = 0; k < ncl_live; ++k)
      mx = fmaxf(mx, __ldcg(&ws_ml[(part + k) * HG + r]).x);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ncl_live; ++k) {
      const float2 ml = __ldcg(&ws_ml[(part + k) * HG + r]);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          ws_o + ((part + k) * HG + r) * R + c));
      const float w = ex2(ml.x - mx);
      L += w * ml.y;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const float inv = 1.f / L;
    uint2 pk;
    pk.x = pack_bf16(acc.x * inv, acc.y * inv);
    pk.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out_at(r, c)) = pk;
  }
}

// cudaFuncSetAttribute when this launch needs more dynamic shared memory
// than the function was last allowed on this device, not on every launch
template <bool kFp8>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> allowed_smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed_smem[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(mla_decode_kernel<kFp8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) {
    int cur = allowed_smem[dev].load(std::memory_order_acquire);
    while (cur < bytes && !allowed_smem[dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

// the one launch of the bf16 (kFp8 false) or fp8 form
template <bool kFp8>
int mla_decode(const void* q_lat, const void* q_rope, const void* c,
               const void* kr, const void* bt, const void* ctx, void* out,
               void* ws, void* cnt, int B, int H, int R, int RD, int N, int bs,
               int W, int layer, int chunk, int splits, int cluster,
               float scale, void* stream) {
  if (R != kRank || RD != kRopeDim || B <= 0 || H <= 0 || bs <= 0 ||
      chunk <= 0 || chunk % TK || splits <= 0 ||
      cluster != CL_MAX ||
      splits % cluster || (long long)splits * chunk < (long long)W * bs ||
      (splits > cluster && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(chunk, kFp8);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kFp8>((int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q_lat = static_cast<const __nv_bfloat16*>(q_lat);
  p.q_rope = static_cast<const __nv_bfloat16*>(q_rope);
  p.c = c;
  p.kr = kr;
  p.bt = static_cast<const int*>(bt);
  p.ctx_lens = static_cast<const int*>(ctx);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(cnt);
  p.H = H;
  p.N = N;
  p.bs = bs;
  p.W = W;
  p.layer = layer;
  p.chunk = chunk;
  p.scale = scale;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (H + HG - 1) / HG, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mla_decode_kernel<kFp8>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the one launch (0 = launched). The
// wrapper has checked types, shapes, contiguity and 16-byte alignment;
// `chunk` (a multiple of 64), `splits` (a multiple of `cluster`, 8) come
// from the table width (ops/mla_decode.py `plan`); ws holds B * ceil(H / 16) * (splits / cluster) * 16 * (R + 2)
// f32 and cnt at least B * ceil(H / 16) zeroed ints when splits > cluster.
// Only R = 512, RD = 64 is instantiated. q_lat, q_rope and out are bf16; c
// and kr are bf16 here ...
extern "C" int mla_decode_bf16(const void* q_lat, const void* q_rope,
                               const void* c, const void* kr, const void* bt,
                               const void* ctx, void* out, void* ws, void* cnt,
                               int B, int H, int R, int RD, int N, int bs,
                               int W, int layer, int chunk, int splits,
                               int cluster, float scale, void* stream) {
  return mla_decode<false>(q_lat, q_rope, c, kr, bt, ctx, out, ws, cnt, B, H,
                           R, RD, N, bs, W, layer, chunk, splits, cluster,
                           scale, stream);
}

// ... and e4m3 (torch.float8_e4m3fn, no scale) here.
extern "C" int mla_decode_fp8(const void* q_lat, const void* q_rope,
                              const void* c, const void* kr, const void* bt,
                              const void* ctx, void* out, void* ws, void* cnt,
                              int B, int H, int R, int RD, int N, int bs,
                              int W, int layer, int chunk, int splits,
                              int cluster, float scale, void* stream) {
  return mla_decode<true>(q_lat, q_rope, c, kr, bt, ctx, out, ws, cnt, B, H,
                          R, RD, N, bs, W, layer, chunk, splits, cluster,
                          scale, stream);
}
