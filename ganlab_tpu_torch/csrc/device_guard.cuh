// Makes `device` the calling thread's current CUDA device for the guard's
// lifetime and restores the previous one afterwards; does nothing when it
// already is (the usual case, two runtime calls that launch nothing). The
// C entry points hold one around their launch, so that the Python wrappers
// need no device context per call.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int previous = -1;
  explicit DeviceGuard(int device) {
    int current = -1;
    if (cudaGetDevice(&current) == cudaSuccess && current != device &&
        cudaSetDevice(device) == cudaSuccess) {
      previous = current;
    }
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
