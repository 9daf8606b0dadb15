// Native radix-tree KV indexer + token block hashing — the KV router's two
// hot paths (per-request hashing + prefix matching over the global index),
// implemented in C++ with a flat C API consumed via ctypes.
//
// The port's copy of the reference package's native core. Semantics mirror
// dynamo_tpu_torch/kv_router/indexer.py's RadixTree (the plain version)
// exactly: tests/test_torch_native.py holds scores and frequencies equal on
// seeded event streams. Built by ops/_build.py with the host compiler into
// the native library (with capi.cc) and loaded by dynamo_tpu_torch/native.
// Reference analog: the dedicated-thread Rust radix actor at
// reference lib/llm/src/kv_router/indexer.rs:239-379 (find_matches /
// apply_event / remove_worker) — here a mutex-guarded tree the caller's
// event loop owns, since the Python runtime is asyncio-confined.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "xxhash64.h"

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

struct Node {
  uint64_t hash = 0;
  Node* parent = nullptr;
  std::unordered_map<uint64_t, Node*> children;
  std::unordered_set<uint32_t> workers;  // interned worker ids
  double last_update = 0.0;
};

struct MatchResult {
  std::vector<std::pair<std::string, uint32_t>> scores;  // worker → depth
  std::vector<uint32_t> frequencies;                     // holders per depth
};

struct Tree {
  Node root;
  std::unordered_map<uint64_t, Node*> lookup;
  double expiration_s = -1.0;  // <0: disabled
  std::mutex mu;

  // worker-id interning (ids cross the C boundary as strings)
  std::unordered_map<std::string, uint32_t> worker_ids;
  std::vector<std::string> worker_names;

  ~Tree() {
    for (auto& [h, n] : lookup) delete n;
  }

  uint32_t intern(const char* worker) {
    auto it = worker_ids.find(worker);
    if (it != worker_ids.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(worker_names.size());
    worker_names.emplace_back(worker);
    worker_ids.emplace(worker_names.back(), id);
    return id;
  }

  void prune(Node* node) {
    while (node != nullptr && node != &root) {
      if (!node->workers.empty() || !node->children.empty()) break;
      Node* parent = node->parent;
      if (parent != nullptr) parent->children.erase(node->hash);
      lookup.erase(node->hash);
      delete node;
      node = parent;
    }
  }

  void apply_stored(uint32_t worker, bool has_parent, uint64_t parent_hash,
                    const uint64_t* hashes, size_t n) {
    Node* parent = &root;
    if (has_parent) {
      auto it = lookup.find(parent_hash);
      // unknown parent (dropped/expired) → root the chain so the blocks stay
      // discoverable standalone — same recovery as the Python tree
      if (it != lookup.end()) parent = it->second;
    }
    double now = now_s();
    for (size_t i = 0; i < n; ++i) {
      uint64_t h = hashes[i];
      Node* node;
      auto it = lookup.find(h);
      if (it == lookup.end()) {
        node = new Node();
        node->hash = h;
        node->parent = parent;
        parent->children.emplace(h, node);
        lookup.emplace(h, node);
      } else {
        node = it->second;
        if (node->parent == &root && parent != &root) {
          // orphan-rooted earlier (parent event late/dropped) — re-link under
          // the real parent so prefix walks see the full chain
          root.children.erase(h);
          node->parent = parent;
          parent->children.emplace(h, node);
        }
      }
      node->workers.insert(worker);
      node->last_update = now;
      parent = node;
    }
  }

  void apply_removed(uint32_t worker, const uint64_t* hashes, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      auto it = lookup.find(hashes[i]);
      if (it == lookup.end()) continue;
      Node* node = it->second;
      node->workers.erase(worker);
      if (node->workers.empty() && node->children.empty()) prune(node);
    }
  }

  void remove_worker(uint32_t worker) {
    std::vector<Node*> dead;
    for (auto& [h, node] : lookup) {
      node->workers.erase(worker);
      if (node->workers.empty() && node->children.empty()) dead.push_back(node);
    }
    for (Node* node : dead) prune(node);
  }

  MatchResult find_matches(const uint64_t* hashes, size_t n, bool early_exit) {
    MatchResult out;
    // per-worker consecutive-match score, keyed by interned id
    std::unordered_map<uint32_t, uint32_t> scores;
    Node* node = &root;
    double now = now_s();
    std::unordered_set<uint32_t> active;
    bool first = true;
    for (size_t i = 0; i < n; ++i) {
      auto it = node->children.find(hashes[i]);
      if (it == node->children.end()) break;
      Node* child = it->second;
      if (expiration_s >= 0.0 && now - child->last_update > expiration_s) break;
      if (first) {
        active = child->workers;
        first = false;
      } else {
        for (auto ait = active.begin(); ait != active.end();) {
          if (!child->workers.count(*ait)) ait = active.erase(ait);
          else ++ait;
        }
      }
      if (active.empty()) break;
      for (uint32_t w : active) scores[w] += 1;
      out.frequencies.push_back(static_cast<uint32_t>(child->workers.size()));
      if (early_exit && active.size() == 1) {
        uint32_t only = *active.begin();
        Node* nn = child;
        for (size_t j = out.frequencies.size(); j < n; ++j) {
          auto jt = nn->children.find(hashes[j]);
          if (jt == nn->children.end() || !jt->second->workers.count(only)) break;
          nn = jt->second;
          scores[only] += 1;
          out.frequencies.push_back(static_cast<uint32_t>(nn->workers.size()));
        }
        break;
      }
      node = child;
    }
    out.scores.reserve(scores.size());
    for (auto& [w, s] : scores) out.scores.emplace_back(worker_names[w], s);
    return out;
  }

  size_t clear_expired() {
    if (expiration_s < 0.0) return 0;
    double cutoff = now_s() - expiration_s;
    std::vector<Node*> dead;
    for (auto& [h, node] : lookup)
      if (node->last_update < cutoff && node->children.empty()) dead.push_back(node);
    for (Node* node : dead) prune(node);
    return dead.size();
  }
};

}  // namespace

extern "C" {

// ---- hashing -------------------------------------------------------------

uint64_t dt_xxh64(const void* data, size_t len, uint64_t seed) {
  return dynamo_native::xxh64(data, len, seed);
}

// Chained sequence hashes over complete blocks of uint32 token ids — the
// router hot path (plain version: dynamo_tpu_torch/tokens.py
// compute_block_hashes_plain;
// reference: lib/llm/src/kv_router/indexer.rs:123). Returns #hashes written.
size_t dt_compute_block_hashes(const uint32_t* tokens, size_t n_tokens,
                               size_t block_size, uint64_t seed,
                               uint64_t* out /* cap n_tokens/block_size */) {
  if (block_size == 0) return 0;
  size_t n_full = n_tokens / block_size;
  bool have_parent = false;
  uint64_t parent = 0;
  for (size_t i = 0; i < n_full; ++i) {
    uint64_t bh = dynamo_native::xxh64(tokens + i * block_size,
                                       block_size * sizeof(uint32_t), seed);
    if (have_parent) {
      uint64_t buf[2] = {parent, bh};
      parent = dynamo_native::xxh64(buf, sizeof(buf), 0);
    } else {
      parent = bh;
      have_parent = true;
    }
    out[i] = parent;
  }
  return n_full;
}

// ---- radix tree ----------------------------------------------------------

void* dt_tree_new(double expiration_s /* <0: disabled */) {
  Tree* t = new Tree();
  t->expiration_s = expiration_s;
  return t;
}

void dt_tree_free(void* tp) { delete static_cast<Tree*>(tp); }

void dt_tree_apply_stored(void* tp, const char* worker, int has_parent,
                          uint64_t parent_hash, const uint64_t* hashes,
                          size_t n) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  t->apply_stored(t->intern(worker), has_parent != 0, parent_hash, hashes, n);
}

void dt_tree_apply_removed(void* tp, const char* worker, const uint64_t* hashes,
                           size_t n) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  t->apply_removed(t->intern(worker), hashes, n);
}

void dt_tree_remove_worker(void* tp, const char* worker) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  t->remove_worker(t->intern(worker));
}

size_t dt_tree_size(void* tp) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  return t->lookup.size();
}

size_t dt_tree_clear_expired(void* tp) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  return t->clear_expired();
}

void* dt_tree_find_matches(void* tp, const uint64_t* hashes, size_t n,
                           int early_exit) {
  Tree* t = static_cast<Tree*>(tp);
  std::lock_guard<std::mutex> lock(t->mu);
  return new MatchResult(t->find_matches(hashes, n, early_exit != 0));
}

size_t dt_result_num_workers(void* rp) {
  return static_cast<MatchResult*>(rp)->scores.size();
}

const char* dt_result_worker(void* rp, size_t i) {
  return static_cast<MatchResult*>(rp)->scores[i].first.c_str();
}

uint32_t dt_result_score(void* rp, size_t i) {
  return static_cast<MatchResult*>(rp)->scores[i].second;
}

size_t dt_result_num_freqs(void* rp) {
  return static_cast<MatchResult*>(rp)->frequencies.size();
}

uint32_t dt_result_freq(void* rp, size_t i) {
  return static_cast<MatchResult*>(rp)->frequencies[i];
}

void dt_result_free(void* rp) { delete static_cast<MatchResult*>(rp); }

}  // extern "C"
