// Shared helpers of the port's stencil kernels (sm_90a, plain C interface).
//
// Layout: every field is a contiguous (x, y, z) array with z fastest, in
// the reference's staggered shapes. Each kernel maps one thread to one
// output point with the flat index z-fastest, so the 32 threads of a warp
// read 32 neighbouring z values of every operand: the loads coalesce, and
// the x/y neighbours a stencil needs are the same rows shifted by a
// plane or a row, which the L1/L2 caches serve to the neighbouring warps.
#pragma once

#include <cuda_runtime.h>

namespace cfdnn {

constexpr int kBlock = 256;

inline unsigned blocks_for(long long n) {
    return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// Periodic neighbours by index arithmetic (no modulo on the hot path).
__device__ __forceinline__ int wrap_m(int i, int n) { return i == 0 ? n - 1 : i - 1; }
__device__ __forceinline__ int wrap_p(int i, int n) { return i == n - 1 ? 0 : i + 1; }

// Flat offset of (i, j, k) in an (., ny, nz) array.
__device__ __forceinline__ long long at3(int i, int j, int k, int ny, int nz) {
    return (static_cast<long long>(i) * ny + j) * nz + k;
}

}  // namespace cfdnn
