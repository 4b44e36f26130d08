// Submission table: duplicate-name detection + handle allocation (the
// port's copy of the JAX package's _native/csrc/table.cc).
//
// Native analogue of the reference TensorQueue (horovod/common/
// tensor_queue.{h,cc}: AddToTensorQueue rejects in-flight duplicate names
// with DUPLICATE_NAME_ERROR) fused with the Torch HandleManager (horovod/
// torch/handle_manager.{h,cc}: integer handles for async ops). Handle
// objects and results stay on the Python side; the native table owns the
// mutexed name->handle bookkeeping that sits on every eager submission.
#include <mutex>
#include <string>
#include <unordered_map>

#include "common.hpp"

namespace {

struct Table {
  std::mutex mu;
  std::unordered_map<std::string, int64_t> in_flight;
  std::unordered_map<int64_t, std::string> handles;
  int64_t next_handle = 0;
};

}  // namespace

HVD_EXPORT void* hvd_table_create() { return new Table(); }

HVD_EXPORT void hvd_table_destroy(void* t) { delete static_cast<Table*>(t); }

// Returns a fresh handle id, or -1 if `name` is already in flight.
HVD_EXPORT int64_t hvd_table_begin(void* t, const char* name) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> lk(tab->mu);
  std::string n(name);
  if (tab->in_flight.count(n)) return -1;
  int64_t h = tab->next_handle++;
  tab->in_flight.emplace(n, h);
  tab->handles.emplace(h, std::move(n));
  return h;
}

// Returns 1 if the handle was known and removed, 0 otherwise.
HVD_EXPORT int32_t hvd_table_finish(void* t, int64_t h) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> lk(tab->mu);
  auto it = tab->handles.find(h);
  if (it == tab->handles.end()) return 0;
  tab->in_flight.erase(it->second);
  tab->handles.erase(it);
  return 1;
}

HVD_EXPORT int32_t hvd_table_known(void* t, int64_t h) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> lk(tab->mu);
  return tab->handles.count(h) ? 1 : 0;
}

HVD_EXPORT int64_t hvd_table_pending(void* t) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> lk(tab->mu);
  return (int64_t)tab->in_flight.size();
}
