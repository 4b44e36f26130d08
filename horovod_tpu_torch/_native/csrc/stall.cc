// Stall inspector bookkeeping (the port's copy of the JAX package's
// _native/csrc/stall.cc).
//
// Native analogue of the reference StallInspector (horovod/common/
// stall_inspector.{h,cc}): tracks when each named submission first
// appeared and reports the ones that have waited past the warn/shutdown
// deadlines. The clock lives here (steady_clock at submit) so the Python
// polling thread only pays one ctypes call per poll; logging/raising stays in
// Python (stall.py) where the message can name ranks and knobs.
#include <chrono>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>

#include "common.hpp"

namespace {

using Clock = std::chrono::steady_clock;

struct Entry {
  Clock::time_point t0;
  bool warned = false;
};

struct Stall {
  std::mutex mu;
  std::unordered_map<std::string, Entry> pending;
};

}  // namespace

HVD_EXPORT void* hvd_stall_create() { return new Stall(); }

HVD_EXPORT void hvd_stall_destroy(void* p) { delete static_cast<Stall*>(p); }

HVD_EXPORT void hvd_stall_submit(void* p, const char* name) {
  auto* s = static_cast<Stall*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  s->pending.emplace(std::string(name), Entry{Clock::now(), false});
}

HVD_EXPORT void hvd_stall_done(void* p, const char* name) {
  auto* s = static_cast<Stall*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  s->pending.erase(std::string(name));
}

HVD_EXPORT int64_t hvd_stall_pending(void* p) {
  auto* s = static_cast<Stall*>(p);
  std::lock_guard<std::mutex> lk(s->mu);
  return (int64_t)s->pending.size();
}

// Scans the table: entries pending longer than warn_s that have not been
// reported yet are marked warned and their names written newline-joined into
// `out` (truncated at cap). Returns the number of newly-warned entries.
// *shutdown_hit is set to 1 when shutdown_s > 0 and any entry exceeds it.
HVD_EXPORT int64_t hvd_stall_check(void* p, double warn_s, double shutdown_s,
                                   int32_t* shutdown_hit, char* out,
                                   int64_t cap) {
  auto* s = static_cast<Stall*>(p);
  auto now = Clock::now();
  int64_t n_new = 0;
  int64_t pos = 0;
  if (cap > 0) out[0] = '\0';
  std::lock_guard<std::mutex> lk(s->mu);
  for (auto& kv : s->pending) {
    double waited =
        std::chrono::duration<double>(now - kv.second.t0).count();
    if (shutdown_s > 0 && waited > shutdown_s && shutdown_hit)
      *shutdown_hit = 1;
    if (waited > warn_s && !kv.second.warned) {
      int64_t len = (int64_t)kv.first.size();
      if (pos + len + 2 >= cap) continue;  // report on a later scan
      kv.second.warned = true;
      n_new++;
      if (pos > 0) out[pos++] = '\n';
      std::memcpy(out + pos, kv.first.data(), len);
      pos += len;
      out[pos] = '\0';
    }
  }
  return n_new;
}
