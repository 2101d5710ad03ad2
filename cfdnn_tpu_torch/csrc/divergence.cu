// divergence: the staggered O2 cell divergence of (u, v, w).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_divergence (body
// _divergence_kernel, which runs ops.operators.divergence on an x-slab).
// For cell (i, j, k):
//     div = sum over axes a of (face_hi - face_lo) * inv_d_a
// with the reference's order of summation (x, then y, then z): projection.cuh
// div_cell, which divergence_xz (xz.cu) shares, with the axis modes
// described there. The plain PyTorch twin is ops.operators.divergence.
//
// Bound on the H100: device-memory bandwidth (three fields in, one out,
// 6 flops a cell). Design: one thread per cell, z fastest within a warp;
// the +1 neighbours along x and y are the same warp's rows a plane or a
// row further, served by L1/L2.
#include "projection.cuh"

namespace {

// The faces in device memory (projection.cuh's reader), with the y and z
// modes that set v's and w's stored extents.
template <typename T>
struct Faces {
    const T* __restrict__ u;
    const T* __restrict__ v;
    const T* __restrict__ w;
    int ny, nz, my, mz;

    template <int C>
    __device__ __forceinline__ T at(int i, int j, int k) const {
        if constexpr (C == 0) return u[cfdnn::at3(i, j, k, ny, nz)];
        else if constexpr (C == 1) return v[cfdnn::at3(i, j, k, my == 1 ? ny : ny + 1, nz)];
        else return w[cfdnn::at3(i, j, k, ny, mz == 1 ? nz : nz + 1)];
    }
};

template <typename T>
__global__ void divergence_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ inv_dx,
        const T* __restrict__ inv_dy, const T* __restrict__ inv_dz,
        T* __restrict__ out, int nx, int ny, int nz, int mx, int my, int mz) {
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(nx) * ny * nz) return;
    const int k = static_cast<int>(idx % nz);
    const long long r = idx / nz;
    const int j = static_cast<int>(r % ny);
    const int i = static_cast<int>(r / ny);
    const Faces<T> faces{u, v, w, ny, nz, my, mz};
    out[idx] = cfdnn::div_cell(faces, inv_dx, inv_dy, inv_dz, i, j, k, nx, ny, nz,
                               mx, my, mz);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* inv_dx,
           const void* inv_dy, const void* inv_dz, void* out,
           int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    divergence_kernel<T><<<cfdnn::blocks_for(n), cfdnn::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(inv_dx),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
        static_cast<T*>(out), nx, ny, nz, mx, my, mz);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_divergence_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<float>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                         nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_divergence_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<double>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                          nx, ny, nz, mx, my, mz, stream);
}
