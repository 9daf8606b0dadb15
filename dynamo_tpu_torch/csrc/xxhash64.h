// XXH64 — 64-bit hash used for KV block / sequence hashing.
//
// Independent implementation of the public XXH64 algorithm (Yann Collet,
// BSD-licensed spec), bit-identical to the pure-Python xxh64 of
// dynamo_tpu_torch/tokens.py (the plain version) and to the reference
// package's native core, whose header this copies. Block hashes are salted
// with a fixed seed (reference: lib/llm/src/kv_router/indexer.rs:64,
// lib/tokens/src/lib.rs:16-120). Host code, built by ops/_build.py with the
// host compiler (not nvcc).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace dynamo_native {

namespace detail {
constexpr uint64_t kPrime1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kPrime2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kPrime3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kPrime4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kPrime5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

inline uint64_t round64(uint64_t acc, uint64_t input) {
  acc += input * kPrime2;
  acc = rotl64(acc, 31);
  return acc * kPrime1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round64(0, val);
  return acc * kPrime1 + kPrime4;
}
}  // namespace detail

inline uint64_t xxh64(const void* data, size_t len, uint64_t seed) {
  using namespace detail;
  const uint8_t* p = static_cast<const uint8_t*>(data);
  const uint8_t* const end = p + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + kPrime1 + kPrime2;
    uint64_t v2 = seed + kPrime2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - kPrime1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = round64(v1, read64(p));
      v2 = round64(v2, read64(p + 8));
      v3 = round64(v3, read64(p + 16));
      v4 = round64(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + kPrime5;
  }

  h += static_cast<uint64_t>(len);

  while (p + 8 <= end) {
    h ^= round64(0, read64(p));
    h = rotl64(h, 27) * kPrime1 + kPrime4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * kPrime1;
    h = rotl64(h, 23) * kPrime2 + kPrime3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * kPrime5;
    h = rotl64(h, 11) * kPrime1;
    ++p;
  }

  h ^= h >> 33;
  h *= kPrime2;
  h ^= h >> 29;
  h *= kPrime3;
  h ^= h >> 32;
  return h;
}

}  // namespace dynamo_native
