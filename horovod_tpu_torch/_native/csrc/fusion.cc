// Fusion planner: greedy in-order gradient bucketing (the port's copy of
// the JAX package's _native/csrc/fusion.cc).
//
// Native analogue of the reference's response fusion (horovod/common/
// controller.cc FuseResponses + fusion_buffer_manager): consecutive tensors
// share a bucket until the byte threshold is exceeded. Semantics are kept
// identical to the pure-Python planner (horovod_tpu_torch/fusion.py
// plan_buckets); tests assert parity.
#include "common.hpp"

// Writes the bucket index of each tensor into out[i]; returns the number of
// buckets. threshold <= 0 disables fusion (one bucket per tensor).
HVD_EXPORT int64_t hvd_plan_buckets(const int64_t* nbytes, int64_t n,
                                    int64_t threshold, int32_t* out) {
  if (n <= 0) return 0;
  if (threshold <= 0) {
    for (int64_t i = 0; i < n; i++) out[i] = (int32_t)i;
    return n;
  }
  int64_t bucket = 0;
  int64_t cur_bytes = 0;
  bool cur_nonempty = false;
  for (int64_t i = 0; i < n; i++) {
    if (cur_nonempty && cur_bytes + nbytes[i] > threshold) {
      bucket++;
      cur_bytes = 0;
      cur_nonempty = false;
    }
    out[i] = (int32_t)bucket;
    cur_bytes += nbytes[i];
    cur_nonempty = true;
  }
  return bucket + 1;
}
