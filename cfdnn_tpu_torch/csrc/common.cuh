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

#include <atomic>

#include "tile_plan.cuh"

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

// The chunk of y planes a block of `Kernel` (a walked (x, z) tile of
// `Threads` threads and `smem` bytes of dynamic shared memory) walks over
// `tiles` tiles and `rows` rows on the current device: plan::chunk with
// the blocks the device holds at once (its SMs times the kernel's
// resident blocks an SM), asked once a device.
template <auto Kernel, int Threads>
int walk_chunk(long long tiles, int rows, size_t smem = 0) {
    constexpr int kDevices = 64;
    static std::atomic<int> resident[kDevices];
    int dev = 0;
    cudaGetDevice(&dev);
    int held = dev < kDevices ? resident[dev].load(std::memory_order_relaxed)
                              : 0;
    if (held == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      Threads, smem);
        held = sms * per_sm;
        if (dev < kDevices)
            resident[dev].store(held, std::memory_order_relaxed);
    }
    return plan::chunk(tiles, rows, held);
}

}  // namespace cfdnn
