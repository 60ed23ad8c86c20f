// Element access for the scenario-last ("lanes") layout of the one-thread-
// per-scenario PDIP kernels (K4b, K4c of riccati_bwd.cu): a per-scenario (H, r, c) array of B
// scenarios is stored as (H, r, c, B), so neighbouring threads (scenarios)
// touch neighbouring addresses and every access coalesces.
#pragma once

namespace reak {

template <typename T>
struct Lanes {
  // element (h, i, j) of a per-scenario (H, r, c) array, scenario b; T may
  // be const for an input
  T* p;
  int r, c, B;
  __device__ T& operator()(int h, int i, int j, int b) const {
    return p[((static_cast<long long>(h) * r + i) * c + j) * B + b];
  }
};

}  // namespace reak
