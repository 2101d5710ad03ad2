// correct: the O2 pressure correction u, v, w -= dt * grad(p) at the
// stored faces.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_correct (body
// _correct_kernel, which runs ops.operators.pressure_grad_face on an
// x-slab). At face f of axis a, between cells f-1 and f:
//     grad = (p[f] - p[f-1]) * inv_dc_a[f]
// with the periodic wrap on a periodic axis, and on a bounded axis the
// Neumann copy ghost of bc.pad_pressure, which makes the gradient at the
// two boundary faces exactly zero. The plain PyTorch twin is
// ops.operators.correct_velocity.
//
// The gradient is projection.cuh face_grad, which correct_xz (xz.cu)
// shares, with the axis modes described there.
//
// Bound on the H100: device-memory bandwidth (four fields in, three out,
// 3 flops a face). Design: one launch covers the three components as one
// flat index range [u | v | w], one thread per face, z fastest within a
// warp; dt is read from device memory so that the launch needs no host
// value.
#include "projection.cuh"

namespace {

// The pressure in device memory (projection.cuh's reader).
template <typename T>
struct Cells {
    const T* __restrict__ p;
    int ny, nz;

    __device__ __forceinline__ T operator()(int i, int j, int k) const {
        return p[cfdnn::at3(i, j, k, ny, nz)];
    }
};

template <typename T>
__global__ void correct_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ p,
        const T* __restrict__ dt_ptr, const T* __restrict__ inv_dcx,
        const T* __restrict__ inv_dcy, const T* __restrict__ inv_dcz,
        T* __restrict__ ou, T* __restrict__ ov, T* __restrict__ ow,
        int nx, int ny, int nz, int mx, int my, int mz) {
    const int nfx = mx == 2 ? nx + 1 : nx;
    const int nfy = my == 2 ? ny + 1 : ny;
    const int nfz = mz == 2 ? nz + 1 : nz;
    const long long n_u = static_cast<long long>(nfx) * ny * nz;
    const long long n_v = static_cast<long long>(nx) * nfy * nz;
    const long long n_w = static_cast<long long>(nx) * ny * nfz;
    long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const T* f;
    T* o;
    const T* inv_dc;
    int axis, mode, s1, s2;   // component's y and z extents
    if (idx < n_u) {
        f = u; o = ou; inv_dc = inv_dcx; axis = 0; mode = mx; s1 = ny; s2 = nz;
    } else if (idx < n_u + n_v) {
        idx -= n_u;
        f = v; o = ov; inv_dc = inv_dcy; axis = 1; mode = my; s1 = nfy; s2 = nz;
    } else if (idx < n_u + n_v + n_w) {
        idx -= n_u + n_v;
        f = w; o = ow; inv_dc = inv_dcz; axis = 2; mode = mz; s1 = ny; s2 = nfz;
    } else {
        return;
    }
    if (mode == 0) {
        o[idx] = f[idx];
        return;
    }
    const int k = static_cast<int>(idx % s2);
    const long long r = idx / s2;
    const int j = static_cast<int>(r % s1);
    const int i = static_cast<int>(r / s1);
    const T g = cfdnn::face_grad(Cells<T>{p, ny, nz}, inv_dc, i, j, k, axis, mode,
                                 nx, ny, nz);
    o[idx] = f[idx] - *dt_ptr * g;
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* p,
           const void* dt, const void* inv_dcx, const void* inv_dcy,
           const void* inv_dcz, void* ou, void* ov, void* ow,
           int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    const long long n =
        static_cast<long long>(mx == 2 ? nx + 1 : nx) * ny * nz
        + static_cast<long long>(nx) * (my == 2 ? ny + 1 : ny) * nz
        + static_cast<long long>(nx) * ny * (mz == 2 ? nz + 1 : nz);
    correct_kernel<T><<<cfdnn::blocks_for(n), cfdnn::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(p),
        static_cast<const T*>(dt), static_cast<const T*>(inv_dcx),
        static_cast<const T*>(inv_dcy), static_cast<const T*>(inv_dcz),
        static_cast<T*>(ou), static_cast<T*>(ov), static_cast<T*>(ow),
        nx, ny, nz, mx, my, mz);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_correct_f32(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<float>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                         ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_f64(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<double>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                          ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}
