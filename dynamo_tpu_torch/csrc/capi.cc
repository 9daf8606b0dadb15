// C ABI for external-engine KV event injection.
//
// Lets a non-Python engine (a C/C++ runtime embedding its own executor, or
// any third-party serving stack) publish KV-cache stored/removed events into the
// router plane without linking Python. Mirrors the reference's C bindings for
// TRT-LLM (reference: lib/bindings/c/src/lib.rs:16-373 — dynamo_llm_init,
// dynamo_kv_event_publish_stored/removed over static globals).
//
// Transport-neutral by design: events serialize to the RouterEvent JSON wire
// format (dynamo_tpu_torch/kv_router/protocols.py) and are delivered to a
// registered sink callback — the Python side installs a ctypes callback that
// forwards to the messaging plane. Without a sink, events accumulate in a
// bounded queue drained via dt_capi_drain (pull mode).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>

#include "xxhash64.h"

namespace {

using SinkFn = void (*)(const char* json, void* user_data);

struct CApiState {
  std::mutex mu;
  bool initialized = false;
  std::string ns, component, worker_id;
  uint32_t kv_block_size = 16;
  uint64_t hash_seed = 1337;
  SinkFn sink = nullptr;
  void* sink_user_data = nullptr;
  std::deque<std::string> queue;  // pull-mode buffer when no sink registered
  size_t max_queue = 65536;
  uint64_t dropped = 0;
};

CApiState& state() {
  static CApiState s;
  return s;
}

// Deliver one serialized event. Must be entered with `lock` held; the sink
// callback is invoked AFTER releasing it — the Python trampoline acquires
// the GIL, and calling it under s.mu would deadlock against a GIL-holding
// thread blocked on s.mu (lock-order inversion mu→GIL vs GIL→mu).
void emit(CApiState& s, std::string json, std::unique_lock<std::mutex>& lock) {
  SinkFn sink = s.sink;
  void* user_data = s.sink_user_data;
  if (sink == nullptr) {
    if (s.queue.size() >= s.max_queue) {
      s.queue.pop_front();
      ++s.dropped;
    }
    s.queue.push_back(std::move(json));
    return;
  }
  lock.unlock();
  sink(json.c_str(), user_data);
}

// JSON string escaping for worker ids (quotes/backslashes/control chars)
std::string json_escape(const std::string& in) {
  std::string out;
  out.reserve(in.size());
  char buf[8];
  for (unsigned char c : in) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c < 0x20) {
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
  return out;
}

void append_u64_array(std::string& out, const uint64_t* v, size_t n) {
  out += '[';
  char buf[32];
  for (size_t i = 0; i < n; ++i) {
    if (i) out += ',';
    std::snprintf(buf, sizeof(buf), "%llu", (unsigned long long)v[i]);
    out += buf;
  }
  out += ']';
}

}  // namespace

extern "C" {

// status codes: 0 ok, 1 already-initialized / not-initialized, 2 bad args
int dt_capi_init(const char* ns, const char* component, const char* worker_id,
                 uint32_t kv_block_size, uint64_t hash_seed) {
  if (ns == nullptr || component == nullptr || worker_id == nullptr ||
      kv_block_size == 0)
    return 2;
  CApiState& s = state();
  std::lock_guard<std::mutex> lock(s.mu);
  if (s.initialized) return 1;
  s.ns = ns;
  s.component = component;
  s.worker_id = json_escape(worker_id);
  s.kv_block_size = kv_block_size;
  s.hash_seed = hash_seed;
  s.initialized = true;
  return 0;
}

int dt_capi_shutdown() {
  CApiState& s = state();
  std::lock_guard<std::mutex> lock(s.mu);
  if (!s.initialized) return 1;
  s.initialized = false;
  s.sink = nullptr;
  s.queue.clear();
  return 0;
}

void dt_capi_set_sink(SinkFn sink, void* user_data) {
  CApiState& s = state();
  std::lock_guard<std::mutex> lock(s.mu);
  s.sink = sink;
  s.sink_user_data = user_data;
}

// Publish stored blocks. The engine hands raw token ids; block (and chained
// sequence) hashes are computed here so external engines never need to
// reimplement the hash scheme. parent_hash: pointer to the sequence hash of
// the preceding block, or NULL for a sequence head.
int dt_kv_event_publish_stored(uint64_t event_id, const uint32_t* token_ids,
                               size_t num_tokens, const uint64_t* parent_hash) {
  CApiState& s = state();
  std::unique_lock<std::mutex> lock(s.mu);
  if (!s.initialized) return 1;
  if (token_ids == nullptr || num_tokens == 0) return 2;

  size_t n_full = num_tokens / s.kv_block_size;
  if (n_full == 0) return 2;

  std::string json = "{\"worker_id\":\"" + s.worker_id + "\",\"event_id\":";
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%llu", (unsigned long long)event_id);
  json += buf;
  json += ",\"stored\":{\"block_hashes\":[";
  bool have_parent = parent_hash != nullptr;
  uint64_t parent = have_parent ? *parent_hash : 0;
  for (size_t i = 0; i < n_full; ++i) {
    uint64_t bh = dynamo_native::xxh64(token_ids + i * s.kv_block_size,
                                       s.kv_block_size * sizeof(uint32_t),
                                       s.hash_seed);
    if (have_parent) {
      uint64_t chain[2] = {parent, bh};
      parent = dynamo_native::xxh64(chain, sizeof(chain), 0);
    } else {
      parent = bh;
      have_parent = true;
    }
    if (i) json += ',';
    std::snprintf(buf, sizeof(buf), "%llu", (unsigned long long)parent);
    json += buf;
  }
  json += "],\"parent_hash\":";
  if (parent_hash != nullptr) {
    std::snprintf(buf, sizeof(buf), "%llu", (unsigned long long)*parent_hash);
    json += buf;
  } else {
    json += "null";
  }
  json += "}}";
  emit(s, std::move(json), lock);
  return 0;
}

int dt_kv_event_publish_removed(uint64_t event_id, const uint64_t* block_hashes,
                                size_t num_blocks) {
  CApiState& s = state();
  std::unique_lock<std::mutex> lock(s.mu);
  if (!s.initialized) return 1;
  if (block_hashes == nullptr || num_blocks == 0) return 2;

  std::string json = "{\"worker_id\":\"" + s.worker_id + "\",\"event_id\":";
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%llu", (unsigned long long)event_id);
  json += buf;
  json += ",\"removed\":{\"block_hashes\":";
  append_u64_array(json, block_hashes, num_blocks);
  json += "}}";
  emit(s, std::move(json), lock);
  return 0;
}

// Pull mode: copy the oldest queued event into out (NUL-terminated).
// Returns the event's byte length (excluding NUL), 0 if the queue is empty,
// or -1 if cap is too small (event stays queued).
long dt_capi_drain(char* out, size_t cap) {
  CApiState& s = state();
  std::lock_guard<std::mutex> lock(s.mu);
  if (s.queue.empty()) return 0;
  const std::string& front = s.queue.front();
  if (front.size() + 1 > cap) return -1;
  std::memcpy(out, front.data(), front.size());
  out[front.size()] = '\0';
  long n = static_cast<long>(front.size());
  s.queue.pop_front();
  return n;
}

uint64_t dt_capi_dropped_events() {
  CApiState& s = state();
  std::lock_guard<std::mutex> lock(s.mu);
  return s.dropped;
}

}  // extern "C"
