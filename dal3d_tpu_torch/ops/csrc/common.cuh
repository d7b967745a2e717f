// Shared by the port's CUDA kernels: each .cu builds into its own shared
// library with a plain C interface (see ops/_build.py). Launch functions
// return the cudaError_t of the launch as an int; 0 is success.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* dal3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
