// The launchers' device switch. A launcher runs on the device index it is
// given and hands the caller's current device back when it returns, so a
// launch on a tensor's device never moves the calling thread's device
// (PyTorch keeps its own notion of the current device on that thread).
#pragma once

#include <cuda_runtime.h>

struct ScopedDevice {
  int prev = -1;
  cudaError_t err;
  explicit ScopedDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess || prev == device) prev = -1;  // nothing to hand back
  }
  ~ScopedDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  ScopedDevice(const ScopedDevice&) = delete;
  ScopedDevice& operator=(const ScopedDevice&) = delete;
};
