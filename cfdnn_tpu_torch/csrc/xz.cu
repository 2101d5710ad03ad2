// The (x, z)-tiled LES and projection kernels: nu_sgs_xz, divergence_xz
// and correct_xz, the functions of nu_sgs.cu, divergence.cu and correct.cu
// on the tile of xz_tile.cuh, for grids whose y-z planes the reference's
// TPU slab cannot hold.
//
// Replace cfdnn_tpu/ops/pallas_kernels.py
//   fused_nu_sgs_xz     (body _nu_sgs_kernel_xz: the closure's model_fn
//                        on an (x, z) tile with its 3 x 3 neighbour blocks),
//   fused_divergence_xz (body _divergence_kernel_xz: ops.divergence on the
//                        5-block, corner-free tile _ext_xz_nc),
//   fused_correct_xz    (body _correct_kernel_xz: pressure_grad_face on
//                        the same 5-block tile of p).
// The plain PyTorch twins are the slab kernels' (ops/kernels.py
// nu_sgs_twin, divergence_twin, correct_twin): the turbulence algebra and
// the operator library. The stencils are the slab kernels' own, read from
// the staged window: les.cuh LesGrid::gradient and nu_closure, and
// projection.cuh div_cell and face_grad.
//
// Grid: periodic uniform x and z (the launchers refuse anything else), y
// periodic or bounded by stationary no-slip walls at any stretching.
//
// Bound on the H100: device-memory bandwidth. nu_sgs_xz reads u, v, w and
// writes nu_t (16 bytes a cell in float32, ~100-250 flops); divergence_xz
// the same bytes and 6 flops; correct_xz reads u, v, w, p and writes
// three faces (28 bytes, 9 flops). Design: xz_tile.cuh's 8 x 32 tile
// walked along y. The gradient's cross terms interpolate in x and z, so
// nu_sgs_xz stages the halo's corners; the divergence and the face
// gradient are axis-aligned and stage none (the reference's 5-block
// tile). The window holds the y-planes each stencil reaches: j - 1 ...
// j + 1 (gradient), j ... j + 1 (divergence: v's upper face), j - 1 ... j
// (gradient of p); correct_xz reads u, v, w at the point itself straight
// from device memory.
#include "les.cuh"
#include "projection.cuh"
#include "xz_tile.cuh"

namespace {

using cfdnn::LesGrid;
using cfdnn::xz::Window;
using cfdnn::xz::fits;
using cfdnn::xz::kThreads;
using cfdnn::xz::kPlane;

// Readers of the staged windows: face or velocity component C, or the
// pressure, at a global in-range point.
template <typename T, int NF, int YLO, int YHI>
struct Staged {
    typename Window<T, NF, YLO, YHI>::View win;

    template <int C>
    __device__ __forceinline__ T at(int i, int j, int k) const {
        return win.read(C, i, j, k);
    }

    __device__ __forceinline__ T operator()(int i, int j, int k) const {
        return win.read(0, i, j, k);
    }
};

// ---- nu_sgs_xz ---------------------------------------------------------

template <typename T, int CLOSURE>
__global__ void __launch_bounds__(kThreads)
nu_sgs_xz_kernel(LesGrid<T> g, const T* __restrict__ delta,
                 T* __restrict__ out, T coeff) {
    __shared__ T buf[3 * 3 * kPlane];
    Window<T, 3, 1, 1> win;
    win.init(buf, g.nx, g.ny, g.nz, g.wall_y, g.ny, true);
    win.field(0, g.u, g.ny);
    win.field(1, g.v, g.nfy());
    win.field(2, g.w, g.ny);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const typename Window<T, 3, 1, 1>::View& view) {
        if (!owns) return;
        const Staged<T, 3, 1, 1> r{view};
        const int j = view.jc;
        T G[3][3];
        g.gradient(r, i, j, k, G);
        out[(i * g.ny + j) * g.nz + k] =
            cfdnn::nu_closure<T, CLOSURE>(G, delta + (j * g.nz + k), coeff);
    });
}

template <typename T, int CLOSURE>
void launch_closure(const LesGrid<T>& g, const T* delta, T* out, T coeff,
                    cudaStream_t stream) {
    nu_sgs_xz_kernel<T, CLOSURE>
        <<<cfdnn::xz::grid(g.nx, g.nz, g.ny), kThreads, 0, stream>>>(
            g, delta, out, coeff);
}

template <typename T>
int launch_nu_sgs(const void* u, const void* v, const void* w,
                  const void* inv_dx, const void* inv_dy, const void* inv_dz,
                  const void* den_x, const void* den_y, const void* den_z,
                  const void* delta, void* out, int nx, int ny, int nz,
                  int wall_y, int wall_z, int closure, double coeff,
                  void* stream) {
    if (wall_z || !fits(nx, wall_y ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y, 0};
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

// ---- divergence_xz -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
divergence_xz_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ w, const T* __restrict__ inv_dx,
                     const T* __restrict__ inv_dy, const T* __restrict__ inv_dz,
                     T* __restrict__ out, int nx, int ny, int nz, int my) {
    __shared__ T buf[3 * 2 * kPlane];
    Window<T, 3, 0, 1> win;
    win.init(buf, nx, ny, nz, my == 2, ny, false);
    win.field(0, u, ny);
    win.field(1, v, my == 2 ? ny + 1 : ny);
    win.field(2, w, ny);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const typename Window<T, 3, 0, 1>::View& view) {
        if (!owns) return;
        const Staged<T, 3, 0, 1> r{view};
        const int j = view.jc;
        out[(i * ny + j) * nz + k] = cfdnn::div_cell(
            r, inv_dx, inv_dy, inv_dz, i, j, k, nx, ny, nz, 1, my, 1);
    });
}

template <typename T>
int launch_divergence(const void* u, const void* v, const void* w,
                      const void* inv_dx, const void* inv_dy,
                      const void* inv_dz, void* out, int nx, int ny, int nz,
                      int mx, int my, int mz, void* stream) {
    if (mx != 1 || mz != 1 || (my != 1 && my != 2)
        || !fits(nx, my == 2 ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    divergence_xz_kernel<T><<<cfdnn::xz::grid(nx, nz, ny), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(inv_dx),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
        static_cast<T*>(out), nx, ny, nz, my);
    return static_cast<int>(cudaGetLastError());
}

// ---- correct_xz --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
correct_xz_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ p,
                  const T* __restrict__ dt_ptr, const T* __restrict__ inv_dcx,
                  const T* __restrict__ inv_dcy, const T* __restrict__ inv_dcz,
                  T* __restrict__ ou, T* __restrict__ ov, T* __restrict__ ow,
                  int nx, int ny, int nz, int my) {
    __shared__ T buf[1 * 2 * kPlane];
    const int nfy = my == 2 ? ny + 1 : ny;
    Window<T, 1, 1, 0> win;
    win.init(buf, nx, ny, nz, my == 2, nfy, false);
    win.field(0, p, ny);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const typename Window<T, 1, 1, 0>::View& view) {
        if (!owns) return;
        const Staged<T, 1, 1, 0> r{view};
        const int j = view.jc;
        if (j < ny) {
            const int c = (i * ny + j) * nz + k;
            ou[c] = u[c] - dt * cfdnn::face_grad(r, inv_dcx, i, j, k, 0, 1, nx, ny, nz);
            ow[c] = w[c] - dt * cfdnn::face_grad(r, inv_dcz, i, j, k, 2, 1, nx, ny, nz);
        }
        const int f = (i * nfy + j) * nz + k;
        ov[f] = v[f] - dt * cfdnn::face_grad(r, inv_dcy, i, j, k, 1, my, nx, ny, nz);
    });
}

template <typename T>
int launch_correct(const void* u, const void* v, const void* w, const void* p,
                   const void* dt, const void* inv_dcx, const void* inv_dcy,
                   const void* inv_dcz, void* ou, void* ov, void* ow, int nx,
                   int ny, int nz, int mx, int my, int mz, void* stream) {
    const int nfy = my == 2 ? ny + 1 : ny;
    if (mx != 1 || mz != 1 || (my != 1 && my != 2) || !fits(nx, nfy, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    correct_xz_kernel<T><<<cfdnn::xz::grid(nx, nz, nfy), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(p),
        static_cast<const T*>(dt), static_cast<const T*>(inv_dcx),
        static_cast<const T*>(inv_dcy), static_cast<const T*>(inv_dcz),
        static_cast<T*>(ou), static_cast<T*>(ov), static_cast<T*>(ow),
        nx, ny, nz, my);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_nu_sgs_xz_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch_nu_sgs<float>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y,
                                den_z, delta, out, nx, ny, nz, wall_y, wall_z,
                                closure, coeff, stream);
}

extern "C" int cfdnn_nu_sgs_xz_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch_nu_sgs<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y,
                                 den_z, delta, out, nx, ny, nz, wall_y, wall_z,
                                 closure, coeff, stream);
}

extern "C" int cfdnn_divergence_xz_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_divergence<float>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                                    nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_divergence_xz_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_divergence<double>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                                     nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_xz_f32(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_correct<float>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                                 ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_xz_f64(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_correct<double>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                                  ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}
