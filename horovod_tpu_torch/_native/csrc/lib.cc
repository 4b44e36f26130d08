// Library identity.
#include "common.hpp"

// Bumped whenever the C API changes shape; the Python loader refuses a
// stale cached .so whose ABI does not match (and rebuilds from source).
// 2: the JAX package's ABI 1 plus hvd_tl_now_us.
HVD_EXPORT int32_t hvd_abi_version() { return 2; }
