// Fused sampling epilogue: the whole per-row decode tail in one launch.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_epilogue.py
// (fused_sampling_epilogue / _epilogue_kernel) in all its forms: the plain
// tail, the guided `extra_bias` and the chained burst's `finish` verdict.
// Per batch row it computes what the plain version
// (dynamo_tpu_torch/ops/epilogue.py `fused_sampling_epilogue_ref`:
// engine/sampling.py `sample`, then the chosen logprob, the count commit
// and the finish helpers) computes:
//
//   x = logits + (bias[slot] + extra_bias[row], when given);
//   repetition / frequency / presence penalties
//   against counts[slot] and seen[slot]; greedy = argmax (lowest index);
//   scaled = penalized / max(T, 1e-6); top-k keeps every value >= the k-th
//   largest; min-p drops p < min_p * max p of softmax(scaled); top-p keeps
//   tokens, in descending value order with ties by descending index (the
//   plain version's flip(argsort(stable=True))), while the mass before them
//   is < top_p; token = argmax(gumbel + kept) (lowest index), or greedy
//   when T <= 0; logprob = log_softmax(x)[token]; with alias_counts,
//   counts[slot, token] += commit.
//
//   With `finish` (the chained burst), one thread of the row goes on, in
//   the same launch: gen_n = gen + commit; hard = (gen_n >= min_new and the
//   token is one of the row's stop ids) or gen_n >= max_new or
//   pos + 2 >= max_model_len; the row's ring of trailing tokens shifts left
//   and takes the token when the row commits, else stays; the rolling
//   suffix hashes h_L = h_{L-1} + (uint32(ring[W - L]) + 1) * P^(L-1) run in
//   uint32 with wraparound (P = 1000003; a -1 pad hashes as 0), and cand =
//   any watched sequence with 0 < len <= MAX_SUFFIX, gen_n >= len,
//   gen_n >= min_new and h_len == its target hash. A few dozen integer
//   operations per row: a tail of the launch, no second kernel.
//
// The value path uses the plain version's f32 operations one for one
// (__fadd_rn / __fmul_rn / __fdiv_rn: no contraction into FMAs), so the
// penalized and scaled values, the greedy argmax, the top-k threshold and
// the gumbel argmax are bit-equal to it. Two sums run in another order:
// the softmax denominators (a min-p boundary within an ulp can flip) and
// the top-p mass, which is accumulated exactly in 2^-48 fixed point instead
// of an f32 cumsum (a token whose preceding mass is within ~1e-7 of top_p
// can flip). Every reduction has a fixed order or is an integer sum, so
// the kernel is deterministic from run to run.
//
// What bounds it on an H100: bytes, one pass over the inputs (a few [V]
// rows per batch row, a few operations per element). The design: one
// thread-block cluster of CS = 8 CTAs per batch row (grid 8 B: batch 8
// runs on 64 SMs), each CTA holding a contiguous slice of the row, ceil(V
// / 8) entries rounded up to a multiple of 8, in its own shared memory
// (16,032 f32 at V 128,256: 64 KB). Pass 1 reads the four inputs once from
// device memory (16 bytes a load, two groups of 8 entries a thread in
// flight, when V is a multiple of 8; else one entry a load, U1 in flight)
// and writes the scaled row into the slice; every later pass reads shared
// memory only, and the gumbel noise is read only where a token is still
// kept. Pass 1 is bound by its arithmetic (~16k entries a CTA, two IEEE
// divisions each on penalised rows): the logprob's log-sum-exp, which feeds
// nothing else, rescales once a group of entries and uses exp2 on the SFU,
// and a row parameter that leaves values as they are (repetition 1,
// frequency and presence 0, temperature 1) is skipped.
//
// The order statistics start from a bound. Each warp's max of the scaled
// slice is exchanged with pass 1's partials; the kk-th largest L of the
// cluster's 128 warp maxima is at most the row's kk-th largest value. With
// top-k (k <= 128), kk = k and every token top-k keeps is >= L; without
// top-k, kk = 32, a second, looser bound L2 is the smallest warp maximum,
// and neither goes below the row max - 110 (where the probability is 0). Each CTA lists its entries >= L, then those in [L2, L) (u16
// indices beside the slice). When one of the two sets holds at most
// GATHER_MAX entries over the row and every token the row can keep (a
// bounded top-k row; a top-p row whose candidates' exact mass reaches
// top_p; a min-p row that drops the bound itself),
// rank 0 reads them all through distributed shared memory, sorts them by
// value and then index, both descending (the plain version's order), and
// walks that order for top-k, min-p, top-p and the gumbel argmax alone.
// Otherwise the whole cluster selects over its slices (or, for a bounded
// top-k row, its lists) with radix selections over the values'
// order-preserving bit pattern: three passes of 11, 11 and 10 bits, each a
// 2048-bin histogram of counts (the k-th largest, the top-p tie cut by
// index) or of fixed-point probability mass (the top-p threshold), each
// CTA's local histogram summed across the cluster between
// cluster.sync()s (rank r sums bins 256 r .. 256 r + 255 of all eight CTAs
// and every CTA scans the totals itself, both reading four bins a 16-byte
// load: a DSMEM request costs more than its bytes), integer sums, exact. After the
// first pass of a selection over a slice each CTA compacts its entries in
// the chosen bin, and the other two passes walk that list.
//
// The argmaxes (lowest index), the log-sum-exp, the row max and the softmax
// sums merge the CTAs' partials in rank order, so every CTA holds the same
// values and makes the same choices. The tie orders follow from global
// indices: the argmax keeps the lowest index; at the top-p cut the r-th
// tie counts from the highest index, over the whole row; at the top-k cut
// every value >= the k-th stays. The count commit and the finish tail run
// on thread 0 of rank 0 once the token is known, and every CTA passes a
// last cluster.sync() before it exits, so that no peer reads the shared
// memory of a CTA that has left.
//
// Vocabulary limit: the slice (f32, a multiple of 8 entries) and its list
// (u16) beside the fixed 28 KB must fit a CTA's 227 KB: V <= 8 * 33,960 =
// 271,680. Any batch size.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/epilogue.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int CS = 8;             // CTAs a cluster: one cluster a batch row
constexpr int NT = 512;           // threads a CTA
constexpr int NW = NT / 32;       // warps a CTA (16)
constexpr int U = 8;              // slice elements a thread loads before it bins any
constexpr int U1 = 8;             // the same for pass 1 (four inputs, device memory)
constexpr int BINS = 2048;        // 11-bit radix digit
constexpr int BPT = BINS / NT;    // bins a thread in the scans
constexpr int BPR = BINS / CS;    // bins whose totals a rank keeps
constexpr uint32_t NONE = 0xffffffffu;  // "no bin": the element does not count
constexpr unsigned FULL = 0xffffffffu;
// probability mass in fixed point: p * 2^48, summed exactly in 64 bits
constexpr float MASS_SCALE = 281474976710656.0f;
constexpr double MASS_SCALE_D = 281474976710656.0;
constexpr int FIXED_BYTES = 28672;  // Shared, rounded up; the slice follows
constexpr int GATHER_MAX = 2048;    // candidates rank 0 sorts (over cnt and mass_lo)
// without top-k, the candidates are the entries >= the 32nd largest warp
// maximum: a top-p nucleus or min-p set seldom reaches past them, and a
// list 4x shorter than the 128th's sorts several times faster
constexpr int UNBOUNDED_KK = 32;
// an entry this far below the row max has probability exactly 0 in f32
// (expf underflows below about -104): top-p and min-p never keep it, so
// without top-k it is no candidate (a guided row's -1e9 entries)
constexpr float ZERO_MASS_BELOW = 110.f;
constexpr int MAX_SMEM = 232448;    // an H100 CTA's dynamic shared memory

struct Shared {
  unsigned int cnt[BINS];      // this CTA's histogram
  unsigned int mass_lo[BINS];  // fixed-point mass per bin: hi * 2^32 + lo
  unsigned int mass_hi[BINS];
  unsigned int tot_cnt[BPR];   // the cluster's totals of bins BPR * rank + t
  unsigned long long tot_mass[BPR];
  unsigned long long scan[NW];
  float f[NW];
  float f2[NW];
  int i[NW];
  int best;
  unsigned int u[2];
  unsigned long long ull[2];
  int n_list, n_back;
  float wm[CS * NW];  // the cluster's warp maxima of the scaled row
  float bound, bound2;  // the candidates' lower bounds
  // this CTA's partials, read by its peers after a cluster barrier; each
  // is written once a launch
  float x_gv, x_lm, x_ls, x_smax, x_s1, x_s2, x_best;
  int x_gi, x_besti;
  float x_wmax[NW];  // each warp's max of the scaled slice
  int x_nc, x_nhi;    // its candidates, those >= the tighter bound
  unsigned long long x_mass, x_mass2;  // their fixed-point masses
};
static_assert(sizeof(Shared) <= FIXED_BYTES, "FIXED_BYTES holds Shared");
static_assert(GATHER_MAX * 8 <= sizeof(unsigned int) * 2 * BINS,
              "the gathered keys fit cnt and mass_lo");
static_assert(BPR <= NT, "a thread a bin in the cluster totals");

// the slice a CTA holds and the dynamic shared memory it needs
// (a multiple of 8 entries, so that a row whose V is a multiple of 8 is read
// 16 bytes at a time in every slice)
__host__ __device__ inline int slice_len(int V) {
  return ((V + CS - 1) / CS + 7) / 8 * 8;
}
inline long long smem_bytes(int V) {
  return ((long long)FIXED_BYTES + 6LL * slice_len(V) + 15) / 16 * 16;
}

// radix passes over a 32-bit key: digits of 11, 11 and 10 bits
__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}
__device__ __forceinline__ uint32_t digit_mask(int pass) {
  return pass == 2 ? 0x3ffu : 0x7ffu;
}

constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive entries from a 16-byte aligned address, as floats / ints
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(u[k] << 16);
    x[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int* p, int (&x)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 b = *reinterpret_cast<const int4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// order-preserving unsigned key of an f32 (a < b  <=>  key(a) < key(b));
// -0.0 maps onto +0.0 so that the two tie as they do in a float compare
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// argmax with the lowest index among equal maxima (torch.argmax)
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// log-sum-exp pair (running max, sum of exp(x - max)); symmetric in its
// arguments so that every lane of a butterfly holds the same value
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, mn))),
                __fmul_rn(s2, expf(__fsub_rn(m2, mn))));
  m = mn;
}

// Block reductions: every thread calls them and gets the result. Each warp
// reduces the NW partials itself, in one fixed order.
__device__ float block_sum(float v, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) sm.f[warp] = v;
  __syncthreads();
  v = lane < NW ? sm.f[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  return v;
}

__device__ void block_argmax(float& v, int& i, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  if (lane == 0) {
    sm.f[warp] = v;
    sm.i[warp] = i;
  }
  __syncthreads();
  v = lane < NW ? sm.f[lane] : -INFINITY;
  i = lane < NW ? sm.i[lane] : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  __syncthreads();
}

// Sum of v over the threads below this one (an exclusive prefix sum in
// thread order); integer, so exact.
__device__ unsigned long long block_excl_scan(unsigned long long v,
                                              Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sm.scan[warp] = incl;
  __syncthreads();
  unsigned long long before = lane < warp ? sm.scan[lane] : 0ull;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(FULL, before, o);
  __syncthreads();
  return before + incl - v;
}

// Adds p to a bin's 64-bit mass exactly with 32-bit atomics: the add that
// wraps the low word carries one into the high word.
__device__ __forceinline__ void add_mass(uint32_t bin, unsigned long long p,
                                         Shared& sm) {
  const uint32_t lo = (uint32_t)p, hi = (uint32_t)(p >> 32);
  const uint32_t old = atomicAdd(&sm.mass_lo[bin], lo);
  const uint32_t carry = old + lo < old ? 1u : 0u;
  if (hi + carry) atomicAdd(&sm.mass_hi[bin], hi + carry);
}

// One local histogram pass over the slice entries j in [0, n) (or, with a
// list, the entries list[0 .. n)): every entry for which key(j, kv, v)
// holds and whose key kv matches the digits found so far adds 1 to the
// count of its digit and, with MASS, mass(v) to its mass. Each thread
// reads U entries before it bins any; a count bin takes one atomic per
// distinct bin of a warp.
template <bool MASS, class KeyFn, class MassFn>
__device__ void histogram(int n, const uint16_t* list, uint32_t prefix,
                          uint32_t mask, int pass, KeyFn key, MassFn mass,
                          Shared& sm) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < n; c0 += NT * U) {
    uint32_t bin[U];
    float v[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int idx = c0 + e * NT + threadIdx.x;
      uint32_t kv = 0;
      bool in = false;
      v[e] = 0.f;
      if (idx < n) {
        const int j = list ? list[idx] : idx;
        in = key(j, kv, v[e]) && (kv & mask) == prefix;
      }
      bin[e] = in ? (kv >> digit_shift(pass)) & digit_mask(pass) : NONE;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (MASS) {
        if (bin[e] == NONE) continue;
        atomicAdd(&sm.cnt[bin[e]], 1u);
        const unsigned long long p = mass(v[e]);
        if (p) add_mass(bin[e], p, sm);
      } else {
        const unsigned peers = __match_any_sync(FULL, bin[e]);
        if (bin[e] != NONE && __ffs(peers) - 1 == lane)
          atomicAdd(&sm.cnt[bin[e]], (unsigned)__popc(peers));
      }
    }
  }
}

struct NoMass {
  __device__ unsigned long long operator()(float) const { return 0ull; }
};

__device__ __forceinline__ void clear_bins(bool mass, Shared& sm) {
  for (int j = threadIdx.x; j < BINS; j += NT) {
    sm.cnt[j] = 0;
    if (mass) sm.mass_lo[j] = sm.mass_hi[j] = 0u;
  }
}

// The cluster's histogram after every CTA built its own: rank r sums bins
// BPR r .. BPR r + BPR - 1 of the eight CTAs into its tot arrays. Every
// CTA's thread passes both barriers. A peer reads this CTA's local bins
// only between the two, and its totals only after the second and before
// the next pass's first, so the next pass may clear and rebuild them.
template <bool MASS>
__device__ void cluster_totals(Shared& sm, cg::cluster_group& cl) {
  cl.sync();  // every CTA's local histogram is complete
  const int rank = (int)cl.block_rank();
  // four consecutive bins a thread, read 16 bytes at a time from each peer
  for (int t = threadIdx.x; t < BPR / 4; t += NT) {
    const int bin = rank * BPR + 4 * t;
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    unsigned long long w[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const Shared* ps = cl.map_shared_rank(&sm, q);
      const uint4 cq = *reinterpret_cast<const uint4*>(&ps->cnt[bin]);
      c.x += cq.x;
      c.y += cq.y;
      c.z += cq.z;
      c.w += cq.w;
      if (MASS) {
        const uint4 lo = *reinterpret_cast<const uint4*>(&ps->mass_lo[bin]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&ps->mass_hi[bin]);
        w[0] += ((unsigned long long)hi.x << 32) | lo.x;
        w[1] += ((unsigned long long)hi.y << 32) | lo.y;
        w[2] += ((unsigned long long)hi.z << 32) | lo.z;
        w[3] += ((unsigned long long)hi.w << 32) | lo.w;
      }
    }
    *reinterpret_cast<uint4*>(&sm.tot_cnt[4 * t]) = c;
    if (MASS) {
      *reinterpret_cast<ulonglong2*>(&sm.tot_mass[4 * t]) = make_ulonglong2(w[0], w[1]);
      *reinterpret_cast<ulonglong2*>(&sm.tot_mass[4 * t + 2]) = make_ulonglong2(w[2], w[3]);
    }
  }
  cl.sync();  // every rank's totals are complete
}

// the cluster's totals of bins bin0 .. bin0 + 3 (bin0 a multiple of 4)
__device__ __forceinline__ uint4 total_cnt4(Shared& sm, cg::cluster_group& cl,
                                            int bin0) {
  return *reinterpret_cast<const uint4*>(
      &cl.map_shared_rank(&sm, bin0 / BPR)->tot_cnt[bin0 % BPR]);
}
__device__ __forceinline__ void total_mass4(Shared& sm, cg::cluster_group& cl,
                                            int bin0,
                                            unsigned long long (&w)[4]) {
  const unsigned long long* t =
      &cl.map_shared_rank(&sm, bin0 / BPR)->tot_mass[bin0 % BPR];
  const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(t);
  const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(t + 2);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// The slice entries j in [0, n) whose key matches the digits found so far,
// compacted into `list` (in no particular order: the passes that walk it
// only count). Each thread tests U entries before it appends any. Returns
// how many.
template <class KeyFn>
__device__ int compact_prefix(int n, uint32_t prefix, uint32_t mask, KeyFn key,
                              uint16_t* list, Shared& sm) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sm.n_list = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += NT * U) {
    bool in[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int j = c0 + e * NT + threadIdx.x;
      uint32_t kv = 0;
      float v;
      in[e] = j < n && key(j, kv, v) && (kv & mask) == prefix;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const unsigned bal = __ballot_sync(FULL, in[e]);
      if (!bal) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(&sm.n_list, __popc(bal));
      base = __shfl_sync(FULL, base, 0);
      if (in[e])
        list[base + __popc(bal & ((1u << lane) - 1u))] =
            (uint16_t)(c0 + e * NT + threadIdx.x);
    }
  }
  __syncthreads();
  return sm.n_list;
}

// One pass over the slice: the entries >= hi to the front of `list`, those
// in [lo, hi) after them (appended from the list's far end, then moved up
// to follow the front part when the two cannot overlap). Sets n_hi and
// n_all (the list's length with both parts; n_hi when the move could
// overlap, so that the loose part is not offered).
__device__ void compact2(int n, float lo, float hi, const float* xs,
                         uint16_t* list, int cap, Shared& sm, int& n_hi,
                         int& n_all) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sm.n_list = sm.n_back = 0;
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += NT * U) {
    float v[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int j = c0 + e * NT + threadIdx.x;
      v[e] = j < n ? xs[j] : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int j = c0 + e * NT + threadIdx.x;
      const bool in_hi = j < n && v[e] >= hi;
      const bool in_lo = j < n && !in_hi && v[e] >= lo;
      const unsigned bh = __ballot_sync(FULL, in_hi), bl = __ballot_sync(FULL, in_lo);
      if (!(bh | bl)) continue;  // most warps hold no candidate
      const unsigned below = (1u << lane) - 1u;
      int base_h = 0, base_l = 0;
      if (lane == 0) {
        if (bh) base_h = atomicAdd(&sm.n_list, __popc(bh));
        if (bl) base_l = atomicAdd(&sm.n_back, __popc(bl));
      }
      base_h = __shfl_sync(FULL, base_h, 0);
      base_l = __shfl_sync(FULL, base_l, 0);
      if (in_hi) list[base_h + __popc(bh & below)] = (uint16_t)j;
      if (in_lo) list[cap - 1 - (base_l + __popc(bl & below))] = (uint16_t)j;
    }
  }
  __syncthreads();
  n_hi = sm.n_list;
  const int nb = sm.n_back;
  const bool move = n_hi + 2 * nb <= cap;
  if (move)
    for (int t = threadIdx.x; t < nb; t += NT) list[n_hi + t] = list[cap - 1 - t];
  n_all = move ? n_hi + nb : n_hi;
  __syncthreads();
}

// The k-th largest (k >= 1), over the whole row, of the 32-bit keys that
// key(j, kv, v) yields for the slice entries j in [0, n), or for the
// entries src[0 .. n) when a list is given (entries for which it returns
// false do not count). Every CTA of the cluster calls it and gets the same
// key.
template <class KeyFn>
__device__ uint32_t kth_largest_key(int n, const uint16_t* src, uint32_t k,
                                    KeyFn key, uint16_t* list, Shared& sm,
                                    cg::cluster_group& cl) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  int n_in = n;
  for (int pass = 0; pass < 3; ++pass) {
    clear_bins(false, sm);
    if (tid == 0) {
      sm.u[0] = 0;
      sm.u[1] = 1;
    }
    __syncthreads();
    histogram<false>(n_in, src, prefix, mask, pass, key, NoMass(), sm);
    cluster_totals<false>(sm, cl);
    // thread t owns bins BINS-1-BPT*t .. BINS-BPT*(t+1), highest first, so
    // the prefix over lower threads counts the keys in higher bins
    static_assert(BPT == 4, "a thread's bins are one 16-byte read");
    const uint4 c4 = total_cnt4(sm, cl, BINS - BPT * (tid + 1));
    const uint32_t c[BPT] = {c4.w, c4.z, c4.y, c4.x};  // highest bin first
    const uint32_t own = c[0] + c[1] + c[2] + c[3];
    uint32_t above = (uint32_t)block_excl_scan(own, sm);
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (above < k && above + c[j] >= k) {
        sm.u[0] = BINS - 1 - BPT * tid - j;
        sm.u[1] = k - above;
      }
      above += c[j];
    }
    __syncthreads();
    prefix |= sm.u[0] << digit_shift(pass);
    mask |= digit_mask(pass) << digit_shift(pass);
    k = sm.u[1];
    __syncthreads();
    if (pass == 0 && src == nullptr) {
      n_in = compact_prefix(n, prefix, mask, key, list, sm);
      src = list;
    }
  }
  return prefix;
}

// Over keys in ascending order (ties share a key), over the whole row, the
// largest key whose exclusive prefix mass is below T (> 0), where key(j,
// kv, v) yields each slice entry's key and value (over [0, n), or src[0 ..
// n) when a list is given) and mass(v) its fixed-point mass. Returns the
// key; `below` is the mass of all smaller keys, `n_eq` / `mass_eq` the
// count and mass at the key. The same in every CTA of the cluster.
template <class KeyFn, class MassFn>
__device__ uint32_t mass_threshold_key(int n, const uint16_t* src,
                                       unsigned long long T,
                                       KeyFn key, MassFn mass, uint16_t* list,
                                       Shared& sm, cg::cluster_group& cl,
                                       unsigned long long& below,
                                       uint32_t& n_eq,
                                       unsigned long long& mass_eq) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  unsigned long long base = 0;
  int n_in = n;
  for (int pass = 0; pass < 3; ++pass) {
    clear_bins(true, sm);
    if (tid == 0) {
      sm.best = -1;
      sm.u[0] = 0;
      sm.u[1] = 0;
      sm.ull[0] = base;
      sm.ull[1] = 0ull;
    }
    __syncthreads();
    histogram<true>(n_in, src, prefix, mask, pass, key, mass, sm);
    cluster_totals<true>(sm, cl);
    // thread t owns bins BPT*t .. BPT*t+BPT-1, lowest first
    const uint4 c4 = total_cnt4(sm, cl, BPT * tid);
    const uint32_t c[BPT] = {c4.x, c4.y, c4.z, c4.w};
    unsigned long long w[BPT];
    total_mass4(sm, cl, BPT * tid, w);
    const unsigned long long own = w[0] + w[1] + w[2] + w[3];
    unsigned long long run = base + block_excl_scan(own, sm);
    int cand = -1;
    uint32_t cand_n = 0;
    unsigned long long cand_base = 0, cand_w = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      if (c[j] && run < T) {
        cand = BPT * tid + j;
        cand_base = run;
        cand_n = c[j];
        cand_w = w[j];
      }
      run += w[j];
    }
    if (cand >= 0) atomicMax(&sm.best, cand);
    __syncthreads();
    if (cand >= 0 && cand == sm.best) {
      sm.u[0] = (uint32_t)cand;
      sm.u[1] = cand_n;
      sm.ull[0] = cand_base;
      sm.ull[1] = cand_w;
    }
    __syncthreads();
    prefix |= sm.u[0] << digit_shift(pass);
    mask |= digit_mask(pass) << digit_shift(pass);
    base = sm.ull[0];
    n_eq = sm.u[1];
    mass_eq = sm.ull[1];
    __syncthreads();
    if (pass == 0 && src == nullptr) {
      n_in = compact_prefix(n, prefix, mask, key, list, sm);
      src = list;
    }
  }
  below = base;
  return prefix;
}

__device__ __forceinline__ unsigned long long fixed_mass(float p) {
  return __float2ull_rn(__fmul_rn(p, MASS_SCALE));
}

// A peer's partials of one exchange (read after a cluster barrier; each
// exchange issues its eight reads before it uses any)
__device__ __forceinline__ const Shared& peer(cg::cluster_group& cl,
                                              Shared& sm, int q) {
  return *cl.map_shared_rank(&sm, q);
}

constexpr uint32_t HASH_P = 1000003u;  // engine/sampling.py _HASH_P
constexpr int MAX_SUFFIX = 8;          // engine/sampling.py STOP_SEQ_MAX_LEN

// The chained burst's per-row finish inputs and outputs (all null-free
// when `on`).
struct Finish {
  int on;
  const int* gen;                // [B] generated count before this token
  const int* pos;                // [B] position the step's forward ran at
  const int* min_new;            // [B]
  const int* max_new;            // [B]
  const int* stop_ids;           // [B, n_ids], -1 padded
  const int* ring;               // [B, ring_w] trailing tokens, -1 padded
  const long long* stop_hash;    // [B, n_seqs] targets (low 32 bits)
  const int* stop_hlen;          // [B, n_seqs] lengths (0 = unused)
  uint8_t* hard;                 // [B] out
  uint8_t* cand;                 // [B] out
  int* ring_out;                 // [B, ring_w] out
  int n_ids, ring_w, n_seqs, max_model_len;
};

// One row's finish verdict, run by one thread after the token is chosen.
__device__ void finish_row(const Finish& f, int b, int nt, bool live) {
  const int gen_n = f.gen[b] + (live ? 1 : 0);
  const int mn = f.min_new[b];
  bool hit = false;
  for (int j = 0; j < f.n_ids; ++j) hit |= f.stop_ids[b * f.n_ids + j] == nt;
  f.hard[b] = (gen_n >= mn && hit) || gen_n >= f.max_new[b] ||
              f.pos[b] + 2 >= f.max_model_len;
  const int w = f.ring_w;
  const int* rin = f.ring + (size_t)b * w;
  int* rout = f.ring_out + (size_t)b * w;
  for (int j = 0; j < w; ++j)
    rout[j] = live ? (j + 1 < w ? rin[j + 1] : nt) : rin[j];
  uint32_t h[MAX_SUFFIX + 1];
  uint32_t p_pow = 1u;
  h[0] = 0u;
  for (int l = 1; l <= MAX_SUFFIX; ++l) {
    const uint32_t t = l <= w ? (uint32_t)rout[w - l] + 1u : 0u;
    h[l] = h[l - 1] + t * p_pow;
    p_pow *= HASH_P;
  }
  bool cand = false;
  for (int j = 0; j < f.n_seqs; ++j) {
    const int len = f.stop_hlen[b * f.n_seqs + j];
    if (len > 0 && len <= MAX_SUFFIX && gen_n >= len && gen_n >= mn &&
        h[len] == (uint32_t)f.stop_hash[b * f.n_seqs + j])
      cand = true;
  }
  f.cand[b] = cand;
}

template <typename LogitT, bool EXTRA>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    sampling_epilogue_kernel(
        const LogitT* __restrict__ logits,       // [B, V]
        const float* __restrict__ gumbel,        // [B, V]
        const float* __restrict__ temperature,   // [B]
        const long long* __restrict__ top_k,     // [B]
        const float* __restrict__ top_p,         // [B]
        const float* __restrict__ min_p,         // [B]
        const float* __restrict__ presence,      // [B]
        const float* __restrict__ frequency,     // [B]
        const float* __restrict__ repetition,    // [B]
        int* __restrict__ counts,                // [NS, V]
        const uint8_t* __restrict__ seen,        // [NS, V]
        const float* __restrict__ bias,          // [NS, V]
        const float* __restrict__ extra,         // [B, V] when EXTRA
        const long long* __restrict__ slots,     // [B]
        const uint8_t* __restrict__ commit,      // [B]
        long long* __restrict__ tokens_out,      // [B]
        float* __restrict__ lps_out,             // [B]
        int V, int alias_counts, Finish fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);
  const int SL = slice_len(V);
  float* xs = reinterpret_cast<float*>(smem + FIXED_BYTES);  // the slice
  uint16_t* list = reinterpret_cast<uint16_t*>(xs + SL);     // compacted entries
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int i0 = rank * SL;                  // the slice's first row index
  const int n = max(0, min(SL, V - i0));     // its entries
  const size_t srow = (size_t)slots[b] * V;
  const LogitT* lrow = logits + (size_t)b * V;
  const float* erow = EXTRA ? extra + (size_t)b * V : nullptr;
  const float temp = temperature[b];
  const bool greedy_row = temp <= 0.f;
  const float tclamp = fmaxf(temp, 1e-6f);
  const float rp = repetition[b], fq = frequency[b], pr = presence[b];

  // pass 1: bias, penalties, greedy argmax, the logprob's log-sum-exp and
  // (sampled rows) the scaled slice
  float g_v = -INFINITY, s_max = -INFINITY, lm = -INFINITY, ls = 0.f;
  int g_i = INT_MAX;
  // the row's parameters that leave a value as it is are skipped (y / 1,
  // y * 1 and y - 0 * c are y): bit-equal either way
  const bool use_rp = rp != 1.f, use_fq = fq != 0.f, use_pr = pr != 0.f;
  const bool use_t = tclamp != 1.f;
  // one entry: x = logit + bias, its count and prompt presence
  auto entry = [&](int j, float x, int c, bool sn) {
    const bool gen = c > 0;
    float y = x;
    if (use_rp && (gen || sn)) y = y > 0.f ? __fdiv_rn(y, rp) : __fmul_rn(y, rp);
    if (use_fq) y = __fsub_rn(y, __fmul_rn(fq, (float)c));
    if (use_pr) y = __fsub_rn(y, __fmul_rn(pr, gen ? 1.f : 0.f));
    argmax_merge(g_v, g_i, y, i0 + j);
    if (!greedy_row) {
      const float s = use_t ? __fdiv_rn(y, tclamp) : y;
      xs[j] = s;
      s_max = fmaxf(s_max, s);
    }
  };
  // the logprob's log-sum-exp over a group of K entries (NaN and -inf do
  // not count): one rescale a group, exp2 on the SFU (this sum feeds only
  // the logprob)
  auto lse_group = [&](const auto& x, int k_n) {
    constexpr int K = sizeof(x) / sizeof(x[0]);
    float gm = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < k_n && x[k] > gm) gm = x[k];
    if (gm == -INFINITY) return;
    const float mn = fmaxf(lm, gm);
    float t = ls * ex2f((lm - mn) * kLog2e);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < k_n && x[k] > -INFINITY) t += ex2f((x[k] - mn) * kLog2e);
    lm = mn;
    ls = t;
  };
  const bool vec =
      (V & 7) == 0 &&
      (((uintptr_t)logits | (uintptr_t)bias | (uintptr_t)counts |
        (EXTRA ? (uintptr_t)extra : 0)) & 15) == 0 &&
      ((uintptr_t)seen & 7) == 0;
  if (vec) {  // 8 consecutive entries a thread, UV groups in flight
    constexpr int UV = 2;
    const int ng = n >> 3;  // n is a multiple of 8 here
    for (int g0 = 0; g0 < ng; g0 += NT * UV) {
      float x[UV][8], rb[UV][8];
      int c[UV][8];
      uint2 sn[UV];
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        const int gi = g0 + u * NT + tid;
        if (gi < ng) {
          const int i = i0 + 8 * gi;
          load8(lrow + i, x[u]);
          load8(bias + srow + i, rb[u]);
          load8(counts + srow + i, c[u]);
          sn[u] = *reinterpret_cast<const uint2*>(seen + srow + i);
          if (EXTRA) {
            float eb[8];
            load8(erow + i, eb);
#pragma unroll
            for (int k = 0; k < 8; ++k) rb[u][k] = __fadd_rn(rb[u][k], eb[k]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UV; ++u) {
        const int gi = g0 + u * NT + tid;
        if (gi >= ng) break;
#pragma unroll
        for (int k = 0; k < 8; ++k) x[u][k] = __fadd_rn(x[u][k], rb[u][k]);
        lse_group(x[u], 8);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t sw = k < 4 ? sn[u].x : sn[u].y;
          entry(8 * gi + k, x[u][k], c[u][k],
                ((sw >> (8 * (k & 3))) & 0xffu) != 0);
        }
      }
    }
  } else {  // one entry a thread, U1 in flight
    for (int c0 = 0; c0 < n; c0 += NT * U1) {
      float x[U1];
      int c[U1];
      bool sn[U1];
#pragma unroll
      for (int e = 0; e < U1; ++e) {
        const int j = c0 + e * NT + tid;
        if (j < n) {
          const int i = i0 + j;
          float rb = bias[srow + i];
          if (EXTRA) rb = __fadd_rn(rb, erow[i]);
          x[e] = __fadd_rn(to_float(lrow[i]), rb);
          c[e] = counts[srow + i];
          sn[e] = seen[srow + i];
        }
      }
      const int k_n = min(U1, max(0, (n - c0 - tid + NT - 1) / NT));
      lse_group(x, k_n);
#pragma unroll
      for (int e = 0; e < U1; ++e) {
        const int j = c0 + e * NT + tid;
        if (j >= n) break;
        entry(j, x[e], c[e], sn[e]);
      }
    }
  }
  // pass 1's three reductions in one: warp butterflies (each warp's max
  // of the scaled slice is the top-k candidates' bound), one barrier, then
  // every warp reduces the NW partials in one fixed order
  {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      argmax_merge(g_v, g_i, __shfl_xor_sync(FULL, g_v, o),
                   __shfl_xor_sync(FULL, g_i, o));
      lse_merge(lm, ls, __shfl_xor_sync(FULL, lm, o), __shfl_xor_sync(FULL, ls, o));
      s_max = fmaxf(s_max, __shfl_xor_sync(FULL, s_max, o));
    }
    if (lane == 0) {  // sm.wm is free until the bound is taken
      sm.f[warp] = g_v;
      sm.i[warp] = g_i;
      sm.f2[warp] = lm;
      sm.wm[warp] = ls;
      sm.wm[NW + warp] = s_max;
      sm.x_wmax[warp] = s_max;
    }
    __syncthreads();
    g_v = lane < NW ? sm.f[lane] : -INFINITY;
    g_i = lane < NW ? sm.i[lane] : INT_MAX;
    lm = lane < NW ? sm.f2[lane] : -INFINITY;
    ls = lane < NW ? sm.wm[lane] : 0.f;
    s_max = lane < NW ? sm.wm[NW + lane] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      argmax_merge(g_v, g_i, __shfl_xor_sync(FULL, g_v, o),
                   __shfl_xor_sync(FULL, g_i, o));
      lse_merge(lm, ls, __shfl_xor_sync(FULL, lm, o), __shfl_xor_sync(FULL, ls, o));
      s_max = fmaxf(s_max, __shfl_xor_sync(FULL, s_max, o));
    }
    __syncthreads();
  }
  if (tid == 0) {
    sm.x_gv = g_v;
    sm.x_gi = g_i;
    sm.x_lm = lm;
    sm.x_ls = ls;
    sm.x_smax = s_max;
  }
  cl.sync();
  {  // the cluster's partials in rank order; sampled rows also fetch the
     // cluster's 128 warp maxima in the same round
    float pv[CS], pm[CS], ps[CS], px[CS];
    int pi[CS];
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const Shared& o = peer(cl, sm, q);
      pv[q] = o.x_gv;
      pi[q] = o.x_gi;
      pm[q] = o.x_lm;
      ps[q] = o.x_ls;
      px[q] = o.x_smax;
    }
    if (!greedy_row && tid < CS * NW) {
      const float w = peer(cl, sm, tid / NW).x_wmax[tid % NW];
      sm.wm[tid] = w == w ? w : -INFINITY;
    }
    g_v = -INFINITY;
    g_i = INT_MAX;
    lm = -INFINITY;
    ls = 0.f;
    s_max = -INFINITY;
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      argmax_merge(g_v, g_i, pv[q], pi[q]);
      lse_merge(lm, ls, pm[q], ps[q]);
      s_max = fmaxf(s_max, px[q]);
    }
  }
  int nt = g_i;

  if (!greedy_row) {
    const float m = s_max;
    const long long tk = top_k[b];
    const bool has_topk = tk > 0 && tk < V;
    // min-p and top-p read the softmax of what top-k kept; without them the
    // top-k cut is applied in the gumbel pass and no sum is taken
    const float mp = min_p[b];
    const float tp = top_p[b];
    const bool has_topp = tp < 1.f;
    const unsigned long long T =
        has_topp && tp > 0.f ? (unsigned long long)((double)tp * MASS_SCALE_D)
                             : 0ull;
    const bool need_sums = mp > 0.f || T > 0;

    // the cluster's sum of one partial per CTA, in rank order
    auto cluster_sum = [&](float v, float Shared::*field) {
      v = block_sum(v, sm);
      if (tid == 0) sm.*field = v;
      cl.sync();
      float pv[CS];
#pragma unroll
      for (int q = 0; q < CS; ++q) pv[q] = peer(cl, sm, q).*field;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < CS; ++q) t += pv[q];
      return t;
    };

    // Candidates. The kk-th largest of the cluster's 128 warp maxima is a
    // lower bound L on the row's kk-th largest value (kk distinct entries
    // are >= L): with top-k (k <= 128) kk = k, and every token top-k keeps
    // is >= L; without top-k, kk = UNBOUNDED_KK, and L2 is the smallest
    // warp maximum. Each CTA lists its entries >= L (list[0 .. n_hi)),
    // then those in [L2, L), and the CTAs exchange the lists' lengths.
    const bool bounded = has_topk && tk <= CS * NW;
    const bool probe = bounded || (!has_topk && need_sums);
    int n_c = n, n_hi = n, total = 0, total_hi = 0;
    int off[CS + 1], off_hi[CS + 1];
    float L = -INFINITY, L2 = -INFINITY;
    if (probe) {
      const int kk = bounded ? (int)tk : UNBOUNDED_KK;
      if (tid == 0) sm.bound = sm.bound2 = -INFINITY;  // sm.wm: warp maxima
      __syncthreads();
      if (tid < CS * NW) {
        const float w = sm.wm[tid];
        int r = 0;
        for (int u = 0; u < CS * NW; ++u) {
          const float x = sm.wm[u];
          r += x > w || (x == w && u < tid);
        }
        if (r == kk - 1) sm.bound = w;
        if (r == CS * NW - 1) sm.bound2 = w;
      }
      __syncthreads();
      L = sm.bound;
      L2 = bounded ? L : sm.bound2;
      if (!bounded) {  // below m - 110 expf is 0: no mass, never kept
        L = fmaxf(L, m - ZERO_MASS_BELOW);
        L2 = fmaxf(L2, m - ZERO_MASS_BELOW);
      }
      compact2(n, L2, L, xs, list, SL, sm, n_hi, n_c);
      if (tid == 0) {
        sm.x_nc = n_c;
        sm.x_nhi = n_hi;
      }
      cl.sync();
      int pc[CS], ph[CS];
#pragma unroll
      for (int q = 0; q < CS; ++q) {
        pc[q] = peer(cl, sm, q).x_nc;
        ph[q] = peer(cl, sm, q).x_nhi;
      }
      off[0] = off_hi[0] = 0;
#pragma unroll
      for (int q = 0; q < CS; ++q) {
        off[q + 1] = off[q] + pc[q];
        off_hi[q + 1] = off_hi[q] + ph[q];
      }
      total = off[CS];
      total_hi = off_hi[CS];
    }
    // a bounded top-k row walks its candidates from here on: everything
    // else is dropped
    const uint16_t* cand = bounded ? list : nullptr;
    const int n_it = cand ? n_c : n;
    auto entry_at = [&](int idx) { return cand ? (int)cand[idx] : idx; };

    // Rank 0 alone: every CTA's candidates (entries list[0 .. n_q) of CTA
    // q, at row index q * SL + j), sorted by value descending and, among
    // equal values, by index descending (the plain version's order) as
    // 64-bit keys over the histogram bins; then top-k, min-p, top-p and the
    // gumbel argmax walk that order. With local_sums the softmax sums are
    // taken over the candidates (a bounded top-k row keeps nothing else);
    // else s1 and s2 come from the passes over the slices. Returns the token.
    auto gathered_sample = [&](int total, const int (&off)[CS + 1],
                               bool local_sums, float s1, float s2,
                               const float* grow) -> int {
      unsigned long long* keys = reinterpret_cast<unsigned long long*>(sm.cnt);
      int P = 1;
      while (P < total) P <<= 1;
      for (int g = tid; g < P; g += NT) {
        unsigned long long key = 0ull;  // pads sort last
        if (g < total) {
          int q = 0;
#pragma unroll
          for (int r = 1; r < CS; ++r) q += g >= off[r];
          const int j = cl.map_shared_rank(list, q)[g - off[q]];
          const float v = cl.map_shared_rank(xs, q)[j];
          key = ((unsigned long long)order_key(v) << 32) | (unsigned)(q * SL + j);
        }
        keys[g] = key;
      }
      __syncthreads();
      for (int k = 2; k <= P; k <<= 1)  // bitonic sort, descending
        for (int jj = k >> 1; jj > 0; jj >>= 1) {
          for (int i = tid; i < P; i += NT) {
            const int ixj = i ^ jj;
            if (ixj > i) {
              const unsigned long long a = keys[i], c = keys[ixj];
              if ((i & k) == 0 ? a < c : a > c) {
                keys[i] = c;
                keys[ixj] = a;
              }
            }
          }
          __syncthreads();
        }
      auto val = [&](int p) {  // the inverse of order_key
        const uint32_t kv = (uint32_t)(keys[p] >> 32);
        return __uint_as_float((kv & 0x80000000u) ? (kv & 0x7fffffffu) : ~kv);
      };
      // the length of the prefix of [0, limit) on which pred holds (pred
      // holds on a prefix of the sorted order): the one position where it
      // stops holding writes it
      auto prefix_len = [&](int limit, auto pred) {
        if (tid == 0) sm.u[0] = 0u;
        __syncthreads();
        for (int p = tid; p < limit; p += NT)
          if (pred(p) && (p + 1 == limit || !pred(p + 1))) sm.u[0] = (unsigned)(p + 1);
        __syncthreads();
        const int len = (int)sm.u[0];
        __syncthreads();
        return len;
      };
      auto exp_sum = [&](int limit) {
        float a = 0.f;
        for (int p = tid; p < limit; p += NT) a += expf(__fsub_rn(val(p), m));
        return block_sum(a, sm);
      };
      int len = prefix_len(total, [&](int p) { return val(p) > -INFINITY; });
      if (has_topk && tk < len) {  // every value >= the k-th largest stays
        const uint32_t kth_hi = (uint32_t)(keys[tk - 1] >> 32);
        len = prefix_len(len, [&](int p) {
          return (uint32_t)(keys[p] >> 32) >= kth_hi;
        });
      }
      if (local_sums) s1 = exp_sum(len);
      if (mp > 0.f) {
        const float thr = __fmul_rn(mp, __fdiv_rn(1.f, s1));
        len = prefix_len(len, [&](int p) {
          return !(__fdiv_rn(expf(__fsub_rn(val(p), m)), s1) < thr);
        });
        if (local_sums) s2 = exp_sum(len);
      } else if (local_sums) {
        s2 = s1;
      }
      if (has_topp) {  // keep while the exact mass before the token is < T
        unsigned long long carry = 0;  // the mass before this chunk
        int kept = T > 0 ? len : 0;
        for (int c0 = 0; c0 < len && T > 0; c0 += NT) {
          const int p = c0 + tid;
          const unsigned long long w =
              p < len ? fixed_mass(__fdiv_rn(expf(__fsub_rn(val(p), m)), s2)) : 0ull;
          const unsigned long long ex = carry + block_excl_scan(w, sm);
          if (tid == 0) sm.u[1] = 0xffffffffu;
          if (tid == NT - 1) sm.ull[0] = ex + w;
          __syncthreads();
          // the last kept token: kept, and the next is not (or is past len)
          if (p < len && ex < T && (p + 1 == len || ex + w >= T))
            sm.u[1] = (unsigned)(p + 1);
          __syncthreads();
          carry = sm.ull[0];
          const unsigned cut = sm.u[1];
          __syncthreads();
          if (cut != 0xffffffffu) {
            kept = (int)cut;
            break;
          }
        }
        len = kept;
      }
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int p = tid; p < len; p += NT) {
        const int i = (int)(uint32_t)keys[p];
        argmax_merge(best, best_i, __fadd_rn(val(p), grow[i]), i);
      }
      block_argmax(best, best_i, sm);
      return best == -INFINITY ? 0 : best_i;  // every token dropped: index 0
    };

    // the whole selection on rank 0 when the candidates are few enough
    // and hold every token the row can keep
    bool gathered = bounded && total <= GATHER_MAX;
    float s1 = 0.f, s2 = 0.f;
    uint32_t kth = 0;
    if (!gathered) {
      if (has_topk)
        kth = kth_largest_key(
            n_it, cand, (uint32_t)tk,
            [&](int j, uint32_t& kv, float& s) {
              s = xs[j];
              kv = order_key(s);
              return s == s;
            },
            list, sm, cl);

      // softmax denominator after top-k (its max is the row max: top-k
      // keeps it); the masked entries are written back
      if (need_sums) {
        float acc = 0.f;
        for (int c0 = 0; c0 < n_it; c0 += NT * U) {
          float v[U];
          int j[U];
#pragma unroll
          for (int e = 0; e < U; ++e) {
            const int idx = c0 + e * NT + tid;
            j[e] = idx < n_it ? entry_at(idx) : -1;
            v[e] = j[e] >= 0 ? xs[j[e]] : -INFINITY;
          }
#pragma unroll
          for (int e = 0; e < U; ++e) {
            if (has_topk && v[e] != -INFINITY && order_key(v[e]) < kth) {
              v[e] = -INFINITY;
              xs[j[e]] = v[e];
            }
            acc += expf(__fsub_rn(v[e], m));
          }
        }
        s1 = cluster_sum(acc, &Shared::x_s1);
      }

      // min-p: p < min_p * max p drops, with p = exp(v - m) / s1 and
      // max p = exp(0) / s1
      s2 = s1;
      if (mp > 0.f) {
        const float thr = __fmul_rn(mp, __fdiv_rn(1.f, s1));
        float acc = 0.f;
        for (int c0 = 0; c0 < n_it; c0 += NT * U) {
          float v[U];
          int j[U];
#pragma unroll
          for (int e = 0; e < U; ++e) {
            const int idx = c0 + e * NT + tid;
            j[e] = idx < n_it ? entry_at(idx) : -1;
            v[e] = j[e] >= 0 ? xs[j[e]] : -INFINITY;
          }
#pragma unroll
          for (int e = 0; e < U; ++e) {
            if (v[e] != -INFINITY &&
                __fdiv_rn(expf(__fsub_rn(v[e], m)), s1) < thr) {
              v[e] = -INFINITY;
              xs[j[e]] = v[e];
            }
            acc += expf(__fsub_rn(v[e], m));
          }
        }
        s2 = cluster_sum(acc, &Shared::x_s2);
      }

      // without top-k, the list of entries >= L holds every kept token when
      // top-p's cut falls inside it (its exact mass reaches top_p), or,
      // for min-p alone, when min-p drops L itself (and so all below it)
      if (probe && !bounded && total_hi <= GATHER_MAX) {
        bool hi_ok, all_ok;
        if (T > 0) {  // the candidates' exact masses, of each set
          unsigned long long w_hi = 0, w_all = 0;
          for (int idx = tid; idx < n_c; idx += NT) {
            const float v = xs[list[idx]];
            if (v == -INFINITY) continue;
            const unsigned long long w =
                fixed_mass(__fdiv_rn(expf(__fsub_rn(v, m)), s2));
            w_all += w;
            if (idx < n_hi) w_hi += w;
          }
          // the last thread's inclusive prefix is the CTA's sum
          w_hi = block_excl_scan(w_hi, sm) + w_hi;
          w_all = block_excl_scan(w_all, sm) + w_all;
          if (tid == NT - 1) {
            sm.x_mass = w_hi;
            sm.x_mass2 = w_all;
          }
          cl.sync();
          unsigned long long ph[CS], pa[CS], t_hi = 0, t_all = 0;
#pragma unroll
          for (int q = 0; q < CS; ++q) {
            ph[q] = peer(cl, sm, q).x_mass;
            pa[q] = peer(cl, sm, q).x_mass2;
          }
#pragma unroll
          for (int q = 0; q < CS; ++q) {
            t_hi += ph[q];
            t_all += pa[q];
          }
          hi_ok = t_hi >= T;
          all_ok = t_all >= T;
        } else {  // min-p alone drops a bound, and so everything below it
          const float thr = __fmul_rn(mp, __fdiv_rn(1.f, s1));
          hi_ok = __fdiv_rn(expf(__fsub_rn(L, m)), s1) < thr;
          all_ok = __fdiv_rn(expf(__fsub_rn(L2, m)), s1) < thr;
        }
        if (hi_ok) {  // gather the entries >= L only
          total = total_hi;
#pragma unroll
          for (int q = 0; q <= CS; ++q) off[q] = off_hi[q];
          gathered = true;
        } else {
          gathered = all_ok && total <= GATHER_MAX;
        }
      }
    }

    if (gathered) {
      // rank 0 reads every CTA's candidates (its peers wait at the last
      // cluster barrier) and finishes the row alone
      if (rank == 0)
        nt = gathered_sample(total, off, bounded, s1, s2, gumbel + (size_t)b * V);
    } else {
      // top-p: in descending value order (ties: higher index first) keep
      // while the mass before the token is < top_p. Keys are descending
      // order keys, so "before" is "smaller key". Dropped (-inf) entries
      // carry no mass and sort after every kept one, so they stay out of
      // the histograms: if the cut falls past the last kept value, that
      // value's ties all stay, as they would with the -inf entries counted.
      uint32_t vstar = 0;
      int idx_thr = 0;
      if (T > 0) {
        unsigned long long below = 0, mass_eq = 0;
        uint32_t n_eq = 0;
        vstar = mass_threshold_key(
            n_it, cand, T,
            [&](int j, uint32_t& kv, float& v) {
              v = xs[j];
              kv = ~order_key(v);
              return v == v && v != -INFINITY;
            },
            [&](float v) {
              return fixed_mass(__fdiv_rn(expf(__fsub_rn(v, m)), s2));
            },
            list, sm, cl, below, n_eq, mass_eq);
        // ties at the threshold value: the r-th of them (r = 0 for the
        // highest index of the row) stays iff below + r * p < T
        const unsigned long long p_eq = n_eq ? mass_eq / n_eq : 0ull;
        uint32_t n_keep = n_eq;
        if (p_eq > 0) {
          const unsigned long long need = (T - below + p_eq - 1) / p_eq;
          if (need < n_keep) n_keep = (uint32_t)need;
        }
        if (n_keep < n_eq)
          idx_thr = (int)kth_largest_key(
              n_it, cand, n_keep,
              [&](int j, uint32_t& kv, float&) {
                kv = (uint32_t)(i0 + j);
                return ~order_key(xs[j]) == vstar;
              },
              list, sm, cl);
      }

      // gumbel argmax over the kept tokens (the top-k cut applied here
      // when no sum pass wrote it back); the noise is read only where a
      // token is still kept (-inf + any finite noise is -inf)
      const bool cut_topk = has_topk && !need_sums;
      const float* grow = gumbel + (size_t)b * V + i0;
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int c0 = 0; c0 < n_it; c0 += NT * U) {
        float v[U], gn[U];
        int j[U];
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const int idx = c0 + e * NT + tid;
          j[e] = idx < n_it ? entry_at(idx) : -1;
          v[e] = j[e] >= 0 ? xs[j[e]] : -INFINITY;
          if (cut_topk && v[e] != -INFINITY && order_key(v[e]) < kth)
            v[e] = -INFINITY;
          gn[e] = v[e] != -INFINITY ? grow[j[e]] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < U; ++e) {
          if (j[e] < 0) continue;
          const int i = i0 + j[e];
          float x = v[e];
          if (has_topp) {
            const uint32_t kv = ~order_key(x);
            const bool keep =
                T > 0 && (kv < vstar || (kv == vstar && i >= idx_thr));
            if (!keep) x = -INFINITY;
          }
          argmax_merge(best, best_i, __fadd_rn(x, gn[e]), i);
        }
      }
      block_argmax(best, best_i, sm);
      if (tid == 0) {
        sm.x_best = best;
        sm.x_besti = best_i;
      }
      cl.sync();
      {
        float pv[CS];
        int pi[CS];
#pragma unroll
        for (int q = 0; q < CS; ++q) {
          pv[q] = peer(cl, sm, q).x_best;
          pi[q] = peer(cl, sm, q).x_besti;
        }
        best = -INFINITY;
        best_i = INT_MAX;
#pragma unroll
        for (int q = 0; q < CS; ++q) argmax_merge(best, best_i, pv[q], pi[q]);
        // every token dropped (top_p <= 0): the whole row ties at -inf and
        // the lowest index wins, whichever entries were walked
        if (best == -INFINITY) best_i = 0;
      }
      nt = best_i;
    }
  }

  if (rank == 0 && tid == 0) {
    if (nt == INT_MAX) nt = 0;  // an all-NaN row: torch would pick a NaN
    tokens_out[b] = nt;
    float rb = bias[srow + nt];
    if (EXTRA) rb = __fadd_rn(rb, erow[nt]);
    const float xn = __fadd_rn(to_float(lrow[nt]), rb);
    lps_out[b] = __fsub_rn(__fsub_rn(xn, lm), logf(ls));
    const bool live = commit[b];
    if (alias_counts && live) atomicAdd(&counts[srow + nt], 1);
    if (fin.on) finish_row(fin, b, nt, live);
  }
  cl.sync();  // no CTA leaves while a peer may still read its shared memory
}

template <typename LogitT, bool EXTRA>
int launch(const void* logits, const void* gumbel, const void* temperature,
           const void* top_k, const void* top_p, const void* min_p,
           const void* presence, const void* frequency,
           const void* repetition, void* counts, const void* seen,
           const void* bias, const void* extra, const void* slots,
           const void* commit, void* tokens, void* lps, int B, int V,
           int alias_counts, const Finish& fin, cudaStream_t stream) {
  // the dynamic shared memory attribute, set when a launch needs more than
  // the function was last allowed on this device (per instantiation)
  static std::atomic<int> allowed[64];
  const int smem = (int)smem_bytes(V);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || allowed[dev].load(std::memory_order_acquire) < smem) {
    err = cudaFuncSetAttribute(sampling_epilogue_kernel<LogitT, EXTRA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) {
      int cur = allowed[dev].load(std::memory_order_acquire);
      while (cur < smem && !allowed[dev].compare_exchange_weak(cur, smem)) {
      }
    }
  }
  sampling_epilogue_kernel<LogitT, EXTRA><<<dim3(CS * B), dim3(NT), smem, stream>>>(
      static_cast<const LogitT*>(logits), static_cast<const float*>(gumbel),
      static_cast<const float*>(temperature),
      static_cast<const long long*>(top_k), static_cast<const float*>(top_p),
      static_cast<const float*>(min_p), static_cast<const float*>(presence),
      static_cast<const float*>(frequency),
      static_cast<const float*>(repetition), static_cast<int*>(counts),
      static_cast<const uint8_t*>(seen), static_cast<const float*>(bias),
      static_cast<const float*>(extra), static_cast<const long long*>(slots),
      static_cast<const uint8_t*>(commit), static_cast<long long*>(tokens),
      static_cast<float*>(lps), V, alias_counts, fin);
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster plan, for the wrapper's own copy to be checked against:
// CTAs a row, and the dynamic shared memory a CTA needs at vocabulary V
// (-1 above what a CTA holds).
extern "C" int sampling_epilogue_cluster_size() { return CS; }
extern "C" long long sampling_epilogue_smem_bytes(int V) {
  return V > 0 && smem_bytes(V) <= MAX_SMEM ? smem_bytes(V) : -1;
}

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked dtypes, shapes, devices and contiguity: logits [B, V] bf16
// (logits_bf16 = 1) or f32; gumbel [B, V] f32; the seven sampling
// parameters [B] (top_k int64, the rest f32); counts / seen / bias [NS, V]
// int32 / bool / f32; extra [B, V] f32 or null; slots [B] int64 in
// [0, NS), unique when alias_counts; commit [B] bool; tokens [B] int64;
// lps [B] f32. With with_finish = 1: gen / pos / min_new / max_new [B]
// int32, stop_ids [B, n_ids] int32, ring and ring_out [B, ring_w] int32,
// stop_hash [B, n_seqs] int64 (values in [0, 2^32)), stop_hlen [B, n_seqs]
// int32, hard / cand [B] bool; with with_finish = 0 they are not read. A V
// whose slice does not fit a CTA's shared memory is refused
// (cudaErrorInvalidValue; the wrapper raises before).
extern "C" int sampling_epilogue(
    const void* logits, int logits_bf16, const void* gumbel,
    const void* temperature, const void* top_k, const void* top_p,
    const void* min_p, const void* presence, const void* frequency,
    const void* repetition, void* counts, const void* seen, const void* bias,
    const void* extra, const void* slots, const void* commit, void* tokens,
    void* lps, int B, int V, int alias_counts, int with_finish,
    const void* gen, const void* pos, const void* min_new,
    const void* max_new, const void* stop_ids, const void* ring,
    const void* stop_hash, const void* stop_hlen, void* hard, void* cand,
    void* ring_out, int n_ids, int ring_w, int n_seqs, int max_model_len,
    void* stream) {
  if (B <= 0 || sampling_epilogue_smem_bytes(V) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Finish fin;
  fin.on = with_finish;
  fin.gen = static_cast<const int*>(gen);
  fin.pos = static_cast<const int*>(pos);
  fin.min_new = static_cast<const int*>(min_new);
  fin.max_new = static_cast<const int*>(max_new);
  fin.stop_ids = static_cast<const int*>(stop_ids);
  fin.ring = static_cast<const int*>(ring);
  fin.stop_hash = static_cast<const long long*>(stop_hash);
  fin.stop_hlen = static_cast<const int*>(stop_hlen);
  fin.hard = static_cast<uint8_t*>(hard);
  fin.cand = static_cast<uint8_t*>(cand);
  fin.ring_out = static_cast<int*>(ring_out);
  fin.n_ids = n_ids;
  fin.ring_w = ring_w;
  fin.n_seqs = n_seqs;
  fin.max_model_len = max_model_len;
#define EPILOGUE_LAUNCH(T, E)                                                 \
  launch<T, E>(logits, gumbel, temperature, top_k, top_p, min_p, presence,    \
               frequency, repetition, counts, seen, bias, extra, slots,       \
               commit, tokens, lps, B, V, alias_counts, fin, s)
  if (logits_bf16)
    return extra ? EPILOGUE_LAUNCH(__nv_bfloat16, true)
                 : EPILOGUE_LAUNCH(__nv_bfloat16, false);
  return extra ? EPILOGUE_LAUNCH(float, true) : EPILOGUE_LAUNCH(float, false);
#undef EPILOGUE_LAUNCH
}
