// nu_sgs: the cell eddy viscosity of an algebraic LES closure from the
// nine-component velocity gradient, in one pass over u, v and w.
// (nu_sgs_xz, xz.cu, is the same function on an (x, z) tile.)
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_nu_sgs (body
// _nu_sgs_kernel, which runs the closure's model_fn, turbulence/les.py, on
// an x-slab). The plain PyTorch twin is ops/kernels.py nu_sgs_twin:
// turbulence/base.py strain_rotation and filter_width, then the closure's
// algebra in turbulence/les.py. The closure is a compile-time parameter
// (les.cuh nu_closure: 0 Smagorinsky, 1 WALE, 2 Vreman) with its constant
// `coeff` and the filter width Delta of the cell's
// (y, z) column ((hx dy_j dz_k)^(1/3), filter_width). Sigma is not here:
// the reference runs it plain too (les.py SigmaModel).
//
// Grid and ghost rules: les.cuh (periodic uniform x; y and z each
// periodic uniform or no-slip walls at any stretching: the channel and
// the square duct).
//
// Bound on the H100: device-memory bandwidth (three fields in, one out;
// ~100 flops a cell for Smagorinsky, ~250 for WALE and Vreman, against
// 16 bytes moved a cell in float32). Design: one thread per cell, z
// fastest within a warp; the 30 neighbour loads of the gradient are rows
// a plane or a row away, served by L1/L2, so each field crosses device
// memory about once. No gradient tensor is ever written.
#include "les.cuh"

namespace {

using cfdnn::LesGrid;

template <typename T, int CLOSURE>
__global__ void nu_sgs_kernel(LesGrid<T> g, const T* __restrict__ delta,
                              T* __restrict__ out, T coeff) {
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(g.nx) * g.ny * g.nz) return;
    const int k = static_cast<int>(idx % g.nz);
    const long long r = idx / g.nz;
    const int j = static_cast<int>(r % g.ny);
    const int i = static_cast<int>(r / g.ny);
    T G[3][3];
    g.gradient(i, j, k, G);
    out[idx] = cfdnn::nu_closure<T, CLOSURE>(
        G, delta + (static_cast<long long>(j) * g.nz + k), coeff);
}

template <typename T, int CLOSURE>
void launch_closure(const LesGrid<T>& g, const T* delta, T* out, T coeff,
                    cudaStream_t stream) {
    const long long n = static_cast<long long>(g.nx) * g.ny * g.nz;
    nu_sgs_kernel<T, CLOSURE><<<cfdnn::blocks_for(n), cfdnn::kBlock, 0, stream>>>(
        g, delta, out, coeff);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* inv_dx,
           const void* inv_dy, const void* inv_dz, const void* den_x,
           const void* den_y, const void* den_z, const void* delta, void* out,
           int nx, int ny, int nz, int wall_y, int wall_z, int closure,
           double coeff, void* stream) {
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y,
                       wall_z};
    const T* d = static_cast<const T*>(delta);
    T* o = static_cast<T*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (closure) {
        case 0: launch_closure<T, 0>(g, d, o, T(coeff), s); break;
        case 1: launch_closure<T, 1>(g, d, o, T(coeff), s); break;
        case 2: launch_closure<T, 2>(g, d, o, T(coeff), s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_nu_sgs_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch<float>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y, den_z,
                         delta, out, nx, ny, nz, wall_y, wall_z, closure, coeff,
                         stream);
}

extern "C" int cfdnn_nu_sgs_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y, den_z,
                          delta, out, nx, ny, nz, wall_y, wall_z, closure, coeff,
                          stream);
}
