// Shared by every launch function (the plain C entry points the Python
// wrappers call).
#pragma once
#include <cuda_runtime.h>

// Makes `device` current for the scope of a launch function and restores
// the caller's device after it.
struct device_guard {
  int prev;
  bool switched;
  explicit device_guard(int device) : prev(-1), switched(false) {
    cudaGetDevice(&prev);
    if (prev != device) {
      cudaSetDevice(device);
      switched = true;
    }
  }
  ~device_guard() {
    if (switched && prev >= 0) cudaSetDevice(prev);
  }
};
