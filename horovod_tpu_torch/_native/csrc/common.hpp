// Common declarations of horovod_tpu_torch's native host runtime (the
// port's copy of the JAX package's _native/csrc).
//
// The host runtime around the data plane (NCCL or gloo through
// torch.distributed): submission table, response cache, fusion planning,
// stall detection, timeline writing, autotuning, the components the
// reference implements in horovod/common/{tensor_queue,response_cache,
// fusion_buffer_manager,stall_inspector,timeline,parameter_manager}.{h,cc},
// exposed through a flat C API consumed over ctypes.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(_WIN32)
#define HVD_EXPORT extern "C" __declspec(dllexport)
#else
#define HVD_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace hvdtpu {

// IEEE CRC-32 (matches Python zlib.crc32 so fingerprints agree between the
// native and pure-Python wire paths).
uint32_t crc32_ieee(const uint8_t* data, int64_t len);

}  // namespace hvdtpu
