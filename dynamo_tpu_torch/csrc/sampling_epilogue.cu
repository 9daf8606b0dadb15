// Fused sampling epilogue: the whole per-row decode tail in one launch.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_epilogue.py
// (fused_sampling_epilogue / _epilogue_kernel) in its plain form (no
// finish verdict, no guided extra bias). Per batch row it computes what
// the plain version (dynamo_tpu_torch/engine/sampling.py `sample`, then
// the chosen logprob and the count commit) computes:
//
//   x = logits + bias[slot]; repetition / frequency / presence penalties
//   against counts[slot] and seen[slot]; greedy = argmax (lowest index);
//   scaled = penalized / max(T, 1e-6); top-k keeps every value >= the k-th
//   largest; min-p drops p < min_p * max p of softmax(scaled); top-p keeps
//   tokens, in descending value order with ties by descending index (the
//   plain version's flip(argsort(stable=True))), while the mass before them
//   is < top_p; token = argmax(gumbel + kept) (lowest index), or greedy
//   when T <= 0; logprob = log_softmax(x)[token]; with alias_counts,
//   counts[slot, token] += commit.
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
// What bounds it on an H100: bytes (a few [V] rows per batch row, a few
// operations per element), but this version is latency bound: one CTA
// (1024 threads) per batch row, so batch 8 uses 8 of the 132 SMs. A
// 128,256-entry f32 row (513 KB) does not fit one CTA's shared memory, so
// the scaled row goes to a global scratch row (L2 resident) and the order
// statistics are radix selections over its order-preserving bit pattern:
// three passes of 11, 11 and 10 bits, each building a 2048-bin histogram
// in shared memory — of counts for the k-th largest (top-k; the top-p tie
// cut by index), of fixed-point probability mass for the top-p threshold.
// No sort. What the design does about the latency: every pass over a row
// issues U independent, coalesced loads per thread before it uses any of
// them (U * 1024 loads in flight per SM), and the 64-bit mass sums are
// built from native 32-bit shared atomics (the low word's wrap carries into
// the high word; 64-bit shared atomics made the top-p passes several times
// slower on the H100). Splitting a row over several CTAs and compacting
// the candidates after the first radix pass are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (dynamo_tpu_torch/ops/_build.py); plain C entry
//        point below, bound with ctypes by dynamo_tpu_torch/ops/epilogue.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;          // threads per CTA (one CTA per row)
constexpr int NW = NT / 32;       // warps; == 32, one partial per lane
constexpr int U = 8;              // elements per thread per pass iteration
constexpr int U1 = 4;             // the same for the first pass (4 inputs)
constexpr int BINS = 2048;        // 11-bit radix digit
constexpr int BPT = BINS / NT;    // bins per thread in the histogram scans
constexpr uint32_t NONE = 0xffffffffu;  // "no bin": the element does not count
constexpr unsigned FULL = 0xffffffffu;
// probability mass in fixed point: p * 2^48, summed exactly in 64 bits
constexpr float MASS_SCALE = 281474976710656.0f;
constexpr double MASS_SCALE_D = 281474976710656.0;

struct Shared {
  unsigned int cnt[BINS];
  unsigned int mass_lo[BINS];  // fixed-point mass per bin: hi * 2^32 + lo
  unsigned int mass_hi[BINS];
  unsigned long long scan[NW];
  float f[NW];
  float f2[NW];
  int i[NW];
  int best;
  unsigned int u[2];
  unsigned long long ull[2];
};

// radix passes over a 32-bit key: digits of 11, 11 and 10 bits
__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}
__device__ __forceinline__ uint32_t digit_mask(int pass) {
  return pass == 2 ? 0x3ffu : 0x7ffu;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
  v = sm.f[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  return v;
}

__device__ float block_max(float v, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sm.f[warp] = v;
  __syncthreads();
  v = sm.f[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  return v;
}

__device__ int block_argmax(float v, int i, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  if (lane == 0) {
    sm.f[warp] = v;
    sm.i[warp] = i;
  }
  __syncthreads();
  v = sm.f[lane];
  i = sm.i[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  __syncthreads();
  return i;
}

__device__ void block_lse(float& m, float& s, Shared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_merge(m, s, __shfl_xor_sync(FULL, m, o), __shfl_xor_sync(FULL, s, o));
  if (lane == 0) {
    sm.f[warp] = m;
    sm.f2[warp] = s;
  }
  __syncthreads();
  m = sm.f[lane];
  s = sm.f2[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_merge(m, s, __shfl_xor_sync(FULL, m, o), __shfl_xor_sync(FULL, s, o));
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

// One histogram pass: every element i in [0, n) for which key(i, kv, v)
// holds and whose key kv matches the digits found so far adds 1 to the
// count of its digit and, with MASS, mass(v) to its mass. Each thread
// loads U elements (coalesced: element c0 + e * NT + tid) before it bins
// any.
template <bool MASS, class KeyFn, class MassFn>
__device__ void histogram(int n, uint32_t prefix, uint32_t mask, int pass,
                          KeyFn key, MassFn mass, Shared& sm) {
  for (int c0 = 0; c0 < n; c0 += NT * U) {
    uint32_t bin[U];
    float v[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const int i = c0 + e * NT + threadIdx.x;
      uint32_t kv = 0;
      const bool in = i < n && key(i, kv, v[e]) && (kv & mask) == prefix;
      bin[e] = in ? (kv >> digit_shift(pass)) & digit_mask(pass) : NONE;
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (bin[e] == NONE) continue;
      atomicAdd(&sm.cnt[bin[e]], 1u);
      if (MASS) {
        const unsigned long long p = mass(v[e]);
        if (p) add_mass(bin[e], p, sm);
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

// The k-th largest (k >= 1) of the 32-bit keys that key(i, kv, v) yields
// for i in [0, n) (elements for which it returns false do not count).
template <class KeyFn>
__device__ uint32_t kth_largest_key(int n, uint32_t k, KeyFn key,
                                    Shared& sm) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  for (int pass = 0; pass < 3; ++pass) {
    clear_bins(false, sm);
    if (tid == 0) {
      sm.u[0] = 0;
      sm.u[1] = 1;
    }
    __syncthreads();
    histogram<false>(n, prefix, mask, pass, key, NoMass(), sm);
    __syncthreads();
    // thread t owns bins BINS-1-BPT*t .. BINS-BPT*(t+1), highest first, so
    // the prefix over lower threads counts the keys in higher bins
    uint32_t c[BPT], own = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      c[j] = sm.cnt[BINS - 1 - BPT * tid - j];
      own += c[j];
    }
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
  }
  return prefix;
}

// Over keys in ascending order (ties share a key), the largest key whose
// exclusive prefix mass is below T (> 0), where key(i, kv, v) yields each
// element's key and value and mass(v) its fixed-point mass. Returns the
// key; `below` is the mass of all smaller keys, `n_eq` / `mass_eq` the
// count and mass at the key.
template <class KeyFn, class MassFn>
__device__ uint32_t mass_threshold_key(int n, unsigned long long T,
                                       KeyFn key, MassFn mass, Shared& sm,
                                       unsigned long long& below,
                                       uint32_t& n_eq,
                                       unsigned long long& mass_eq) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  unsigned long long base = 0;
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
    histogram<true>(n, prefix, mask, pass, key, mass, sm);
    __syncthreads();
    // thread t owns bins BPT*t .. BPT*t+BPT-1, lowest first
    uint32_t c[BPT];
    unsigned long long w[BPT], own = 0;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      c[j] = sm.cnt[BPT * tid + j];
      w[j] = ((unsigned long long)sm.mass_hi[BPT * tid + j] << 32) |
             sm.mass_lo[BPT * tid + j];
      own += w[j];
    }
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
  }
  below = base;
  return prefix;
}

__device__ __forceinline__ unsigned long long fixed_mass(float p) {
  return __float2ull_rn(__fmul_rn(p, MASS_SCALE));
}

template <typename LogitT>
__global__ void __launch_bounds__(NT) sampling_epilogue_kernel(
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
    const long long* __restrict__ slots,     // [B]
    const uint8_t* __restrict__ commit,      // [B]
    float* __restrict__ scratch,             // [B, V]
    long long* __restrict__ tokens_out,      // [B]
    float* __restrict__ lps_out,             // [B]
    int V, int alias_counts) {
  __shared__ Shared sm;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t srow = (size_t)slots[b] * V;
  const LogitT* lrow = logits + (size_t)b * V;
  float* xrow = scratch + (size_t)b * V;
  const float temp = temperature[b];
  const bool greedy_row = temp <= 0.f;
  const float tclamp = fmaxf(temp, 1e-6f);
  const float rp = repetition[b], fq = frequency[b], pr = presence[b];

  // pass 1: bias, penalties, greedy argmax, the logprob's log-sum-exp and
  // (sampled rows) the scaled row into scratch
  float g_v = -INFINITY, s_max = -INFINITY, lm = -INFINITY, ls = 0.f;
  int g_i = INT_MAX;
  for (int c0 = 0; c0 < V; c0 += NT * U1) {
    float x[U1];
    int c[U1];
    bool sn[U1];
#pragma unroll
    for (int e = 0; e < U1; ++e) {
      const int i = c0 + e * NT + tid;
      if (i < V) {
        x[e] = __fadd_rn(to_float(lrow[i]), bias[srow + i]);
        c[e] = counts[srow + i];
        sn[e] = seen[srow + i];
      }
    }
#pragma unroll
    for (int e = 0; e < U1; ++e) {
      const int i = c0 + e * NT + tid;
      if (i >= V) break;
      if (x[e] > -INFINITY) {
        if (x[e] > lm) {
          ls = __fadd_rn(__fmul_rn(ls, expf(__fsub_rn(lm, x[e]))), 1.f);
          lm = x[e];
        } else {
          ls = __fadd_rn(ls, expf(__fsub_rn(x[e], lm)));
        }
      }
      const bool gen = c[e] > 0;
      float y = x[e];
      if (gen || sn[e]) y = y > 0.f ? __fdiv_rn(y, rp) : __fmul_rn(y, rp);
      y = __fsub_rn(y, __fmul_rn(fq, (float)c[e]));
      y = __fsub_rn(y, __fmul_rn(pr, gen ? 1.f : 0.f));
      argmax_merge(g_v, g_i, y, i);
      if (!greedy_row) {
        const float s = __fdiv_rn(y, tclamp);
        xrow[i] = s;
        s_max = fmaxf(s_max, s);
      }
    }
  }
  int nt = block_argmax(g_v, g_i, sm);
  block_lse(lm, ls, sm);

  if (!greedy_row) {
    const float m = block_max(s_max, sm);

    // top-k: every value below the k-th largest drops
    const long long tk = top_k[b];
    const bool has_topk = tk > 0 && tk < V;
    uint32_t kth = 0;
    if (has_topk)
      kth = kth_largest_key(
          V, (uint32_t)tk,
          [&](int i, uint32_t& kv, float& s) {
            s = xrow[i];
            kv = order_key(s);
            return s == s;
          },
          sm);

    // softmax denominator after top-k (its max is the row max: top-k
    // keeps it); the masked row is written back
    float acc = 0.f;
    for (int c0 = 0; c0 < V; c0 += NT * U) {
      float v[U];
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int i = c0 + e * NT + tid;
        v[e] = i < V ? xrow[i] : -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        if (has_topk && v[e] != -INFINITY && order_key(v[e]) < kth) {
          v[e] = -INFINITY;
          xrow[c0 + e * NT + tid] = v[e];
        }
        acc += expf(__fsub_rn(v[e], m));
      }
    }
    const float s1 = block_sum(acc, sm);

    // min-p: p < min_p * max p drops, with p = exp(v - m) / s1 and
    // max p = exp(0) / s1
    const float mp = min_p[b];
    float s2 = s1;
    if (mp > 0.f) {
      const float thr = __fmul_rn(mp, __fdiv_rn(1.f, s1));
      acc = 0.f;
      for (int c0 = 0; c0 < V; c0 += NT * U) {
        float v[U];
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const int i = c0 + e * NT + tid;
          v[e] = i < V ? xrow[i] : -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < U; ++e) {
          if (v[e] != -INFINITY &&
              __fdiv_rn(expf(__fsub_rn(v[e], m)), s1) < thr) {
            v[e] = -INFINITY;
            xrow[c0 + e * NT + tid] = v[e];
          }
          acc += expf(__fsub_rn(v[e], m));
        }
      }
      s2 = block_sum(acc, sm);
    }

    // top-p: in descending value order (ties: higher index first) keep
    // while the mass before the token is < top_p. Keys are descending
    // order keys, so "before" is "smaller key".
    const float tp = top_p[b];
    const bool has_topp = tp < 1.f;
    const unsigned long long T =
        has_topp && tp > 0.f ? (unsigned long long)((double)tp * MASS_SCALE_D)
                             : 0ull;
    uint32_t vstar = 0;
    int idx_thr = 0;
    if (T > 0) {
      unsigned long long below = 0, mass_eq = 0;
      uint32_t n_eq = 0;
      vstar = mass_threshold_key(
          V, T,
          [&](int i, uint32_t& kv, float& v) {
            v = xrow[i];
            kv = ~order_key(v);
            return v == v;
          },
          [&](float v) {
            return fixed_mass(__fdiv_rn(expf(__fsub_rn(v, m)), s2));
          },
          sm, below, n_eq, mass_eq);
      // ties at the threshold value: the r-th of them (r = 0 for the
      // highest index) stays iff below + r * p < T
      const unsigned long long p_eq = n_eq ? mass_eq / n_eq : 0ull;
      uint32_t n_keep = n_eq;
      if (p_eq > 0) {
        const unsigned long long need = (T - below + p_eq - 1) / p_eq;
        if (need < n_keep) n_keep = (uint32_t)need;
      }
      if (n_keep < n_eq)
        idx_thr = (int)kth_largest_key(
            V, n_keep,
            [&](int i, uint32_t& kv, float&) {
              kv = (uint32_t)i;
              return ~order_key(xrow[i]) == vstar;
            },
            sm);
    }

    // gumbel argmax over the kept tokens
    const float* grow = gumbel + (size_t)b * V;
    float best = -INFINITY;
    int best_i = INT_MAX;
    for (int c0 = 0; c0 < V; c0 += NT * U) {
      float v[U], gn[U];
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int i = c0 + e * NT + tid;
        v[e] = i < V ? xrow[i] : -INFINITY;
        gn[e] = i < V ? grow[i] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < U; ++e) {
        const int i = c0 + e * NT + tid;
        if (i >= V) break;
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
    nt = block_argmax(best, best_i, sm);
  }

  if (tid == 0) {
    if (nt == INT_MAX) nt = 0;  // an all-NaN row: torch would pick a NaN
    tokens_out[b] = nt;
    const float xn = __fadd_rn(to_float(lrow[nt]), bias[srow + nt]);
    lps_out[b] = __fsub_rn(__fsub_rn(xn, lm), logf(ls));
    if (alias_counts && commit[b]) atomicAdd(&counts[srow + nt], 1);
  }
}

template <typename LogitT>
int launch(const void* logits, const void* gumbel, const void* temperature,
           const void* top_k, const void* top_p, const void* min_p,
           const void* presence, const void* frequency,
           const void* repetition, void* counts, const void* seen,
           const void* bias, const void* slots, const void* commit,
           void* scratch, void* tokens, void* lps, int B, int V,
           int alias_counts, cudaStream_t stream) {
  sampling_epilogue_kernel<LogitT><<<dim3(B), dim3(NT), 0, stream>>>(
      static_cast<const LogitT*>(logits), static_cast<const float*>(gumbel),
      static_cast<const float*>(temperature),
      static_cast<const long long*>(top_k), static_cast<const float*>(top_p),
      static_cast<const float*>(min_p), static_cast<const float*>(presence),
      static_cast<const float*>(frequency),
      static_cast<const float*>(repetition), static_cast<int*>(counts),
      static_cast<const uint8_t*>(seen), static_cast<const float*>(bias),
      static_cast<const long long*>(slots),
      static_cast<const uint8_t*>(commit), static_cast<float*>(scratch),
      static_cast<long long*>(tokens), static_cast<float*>(lps), V,
      alias_counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The wrapper
// has checked dtypes, shapes, devices and contiguity: logits [B, V] bf16
// (logits_bf16 = 1) or f32; gumbel and scratch [B, V] f32; the seven
// sampling parameters [B] (top_k int64, the rest f32); counts / seen /
// bias [NS, V] int32 / bool / f32; slots [B] int64 in [0, NS), unique
// when alias_counts; commit [B] bool; tokens [B] int64; lps [B] f32.
extern "C" int sampling_epilogue(
    const void* logits, int logits_bf16, const void* gumbel,
    const void* temperature, const void* top_k, const void* top_p,
    const void* min_p, const void* presence, const void* frequency,
    const void* repetition, void* counts, const void* seen, const void* bias,
    const void* slots, const void* commit, void* scratch, void* tokens,
    void* lps, int B, int V, int alias_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16)
    return launch<__nv_bfloat16>(logits, gumbel, temperature, top_k, top_p,
                                 min_p, presence, frequency, repetition,
                                 counts, seen, bias, slots, commit, scratch,
                                 tokens, lps, B, V, alias_counts, s);
  return launch<float>(logits, gumbel, temperature, top_k, top_p, min_p,
                       presence, frequency, repetition, counts, seen, bias,
                       slots, commit, scratch, tokens, lps, B, V,
                       alias_counts, s);
}
