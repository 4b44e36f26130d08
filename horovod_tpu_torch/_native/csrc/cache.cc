// Response cache: LRU of validated submission fingerprints (the port's copy
// of the JAX package's _native/csrc/cache.cc).
//
// Native analogue of the reference ResponseCache (horovod/common/
// response_cache.{h,cc}). A hit means this exact (process set, name, shape,
// dtype, op) fingerprint was already validated across processes, so the
// consistency exchange over the wire is skipped. Eviction is reported to
// the caller so every process invalidates the same entries: identical
// deterministic LRU state on every process plays the role of the
// reference's cache-bit sync.
#include <cstdint>
#include <list>
#include <mutex>
#include <unordered_map>

#include "common.hpp"

namespace {

struct Cache {
  std::mutex mu;
  int64_t capacity;
  std::list<uint64_t> lru;  // front = most recent
  std::unordered_map<uint64_t, std::list<uint64_t>::iterator> pos;
};

}  // namespace

HVD_EXPORT void* hvd_cache_create(int64_t capacity) {
  auto* c = new Cache();
  c->capacity = capacity;
  return c;
}

HVD_EXPORT void hvd_cache_destroy(void* p) { delete static_cast<Cache*>(p); }

// 1 = hit (entry refreshed to MRU), 0 = miss.
HVD_EXPORT int32_t hvd_cache_lookup(void* p, uint64_t key) {
  auto* c = static_cast<Cache*>(p);
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->pos.find(key);
  if (it == c->pos.end()) return 0;
  c->lru.splice(c->lru.begin(), c->lru, it->second);
  return 1;
}

// Inserts `key` as MRU. Returns the evicted key via *evicted and 1 if an
// eviction happened, else 0.
HVD_EXPORT int32_t hvd_cache_put(void* p, uint64_t key, uint64_t* evicted) {
  auto* c = static_cast<Cache*>(p);
  std::lock_guard<std::mutex> lk(c->mu);
  if (c->capacity <= 0) return 0;
  auto it = c->pos.find(key);
  if (it != c->pos.end()) {
    c->lru.splice(c->lru.begin(), c->lru, it->second);
    return 0;
  }
  int32_t evict = 0;
  if ((int64_t)c->lru.size() >= c->capacity) {
    uint64_t victim = c->lru.back();
    c->lru.pop_back();
    c->pos.erase(victim);
    if (evicted) *evicted = victim;
    evict = 1;
  }
  c->lru.push_front(key);
  c->pos.emplace(key, c->lru.begin());
  return evict;
}

HVD_EXPORT void hvd_cache_erase(void* p, uint64_t key) {
  auto* c = static_cast<Cache*>(p);
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->pos.find(key);
  if (it == c->pos.end()) return;
  c->lru.erase(it->second);
  c->pos.erase(it);
}

HVD_EXPORT int64_t hvd_cache_size(void* p) {
  auto* c = static_cast<Cache*>(p);
  std::lock_guard<std::mutex> lk(c->mu);
  return (int64_t)c->pos.size();
}

HVD_EXPORT void hvd_cache_clear(void* p) {
  auto* c = static_cast<Cache*>(p);
  std::lock_guard<std::mutex> lk(c->mu);
  c->lru.clear();
  c->pos.clear();
}
