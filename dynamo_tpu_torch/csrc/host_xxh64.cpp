// XXH64 on the host: the cold KV tier's payload checksum.
//
// The cold tier (dynamo_tpu_torch/kv/cold_tier.py) checksums every block
// file it writes and reads with xxh64 over the K bytes then the V bytes,
// the reference's format. The pure-Python xxh64 of dynamo_tpu_torch/tokens.py
// is its plain version and serves the CPU; on a card's host this routine
// serves it (a Llama-3.2-1B bf16 block is 512 KiB). It is plain C++ with a
// C interface, built by ops/_build.py beside the kernels and called through
// ctypes. Streaming form of the published algorithm (XXH64, Yann Collet):
// dyn_xxh64_pair(a, b) equals the digest of the concatenation a || b.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const unsigned char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts (x86-64, aarch64)
  return v;
}

inline uint32_t read32(const unsigned char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t lane_round(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge(uint64_t acc, uint64_t val) {
  acc ^= lane_round(0, val);
  return acc * P1 + P4;
}

struct State {
  uint64_t v[4];
  uint64_t total = 0;
  unsigned char mem[32];
  size_t memsize = 0;
  uint64_t seed;

  explicit State(uint64_t s) : seed(s) {
    v[0] = s + P1 + P2;
    v[1] = s + P2;
    v[2] = s;
    v[3] = s - P1;
  }

  void stripe(const unsigned char* p) {
    v[0] = lane_round(v[0], read64(p));
    v[1] = lane_round(v[1], read64(p + 8));
    v[2] = lane_round(v[2], read64(p + 16));
    v[3] = lane_round(v[3], read64(p + 24));
  }

  void update(const unsigned char* p, size_t len) {
    total += len;
    if (memsize + len < 32) {
      std::memcpy(mem + memsize, p, len);
      memsize += len;
      return;
    }
    if (memsize) {
      size_t fill = 32 - memsize;
      std::memcpy(mem + memsize, p, fill);
      stripe(mem);
      p += fill;
      len -= fill;
      memsize = 0;
    }
    while (len >= 32) {
      stripe(p);
      p += 32;
      len -= 32;
    }
    if (len) {
      std::memcpy(mem, p, len);
      memsize = len;
    }
  }

  uint64_t digest() const {
    uint64_t h;
    if (total >= 32) {
      h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
      for (int i = 0; i < 4; ++i) h = merge(h, v[i]);
    } else {
      h = seed + P5;
    }
    h += total;
    const unsigned char* p = mem;
    size_t len = memsize;
    while (len >= 8) {
      h ^= lane_round(0, read64(p));
      h = rotl(h, 27) * P1 + P4;
      p += 8;
      len -= 8;
    }
    if (len >= 4) {
      h ^= static_cast<uint64_t>(read32(p)) * P1;
      h = rotl(h, 23) * P2 + P3;
      p += 4;
      len -= 4;
    }
    while (len) {
      h ^= static_cast<uint64_t>(*p) * P5;
      h = rotl(h, 11) * P1;
      ++p;
      --len;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

}  // namespace

extern "C" {

uint64_t dyn_xxh64(const void* data, size_t len, uint64_t seed) {
  State s(seed);
  s.update(static_cast<const unsigned char*>(data), len);
  return s.digest();
}

uint64_t dyn_xxh64_pair(const void* a, size_t na, const void* b, size_t nb,
                        uint64_t seed) {
  State s(seed);
  s.update(static_cast<const unsigned char*>(a), na);
  s.update(static_cast<const unsigned char*>(b), nb);
  return s.digest();
}

}  // extern "C"
