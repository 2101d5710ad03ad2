// predictor_general: the fused Euler momentum predictor on a periodic
// uniform x with y and z each periodic (uniform) or bounded by no-slip
// walls at any stretching, moving or not: the LES Taylor-Green, the square
// duct, the lid-driven channel, and through the xpad wrapper a wall x.
// O2 skew or central convection, scalar nu or nu + a cell eddy viscosity.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_general (body
// _general_kernel, which runs ops.convective + ops.diffusive on an
// x-slab). The plain PyTorch twin is ops/kernels.py predictor_general_twin:
// the operator library itself. The terms, written in the twin's order of
// evaluation, are predictor_terms.cuh's, which the (x, z)-tiled kernel
// (predictor_general_xz.cu) shares; here they read the global-memory
// reader Grid.
// Star values at wall faces are computed as the twin computes them; the
// solver's BC pass overwrites them.
//
// Shapes: u (nx, ny, nz), v (nx, nyf, nz), w (nx, ny, nzf), nu_t (nx, ny,
// nz), with nyf = ny + 1 on a wall y (wall faces stored), ny on a periodic
// y, and nzf likewise. Metrics: five device vectors per axis (x, y, z),
// ops/kernels.py general_arrays, passed as a host array of 15 pointers;
// the (lo, hi) tangential wall velocities of u, v, w on y and on z as a
// host array of 12 doubles. Both become plain kernel parameters.
//
// Bound on the H100: device-memory bandwidth (u, v, w and nu_t in, three
// stars out: 28 bytes a cell in float32), against ~300 flops a cell. The
// design is the simple one: one thread per point of the union box
// (nx, nyf, nzf), z fastest within a warp, each thread producing the
// components whose shape holds the point; the grid is (plane blocks, nx),
// so a thread finds its (j, k) with one 32-bit division and no 64-bit
// div/mod, and every offset is a 32-bit multiply-add of strides the host
// computed. Every neighbour and ghost is read from the unpadded arrays
// (rows a plane or a row away, served by L1/L2) and formed in registers;
// the axis rules (periodic wrap or wall ghost) are run-time branches on
// kernel parameters, uniform across a warp except at the wall rows.
#include "predictor_terms.cuh"

namespace {

using namespace cfdnn::general;

template <typename T, bool NUT, bool SKEW>
__global__ void predictor_general_kernel(Grid<T> g, const T* __restrict__ dt_ptr,
                                         T* __restrict__ su, T* __restrict__ sv,
                                         T* __restrict__ sw, T fx) {
    const int ny = g.ax[1].n, nz = g.ax[2].n;
    const int nyf = g.ax[1].wall ? ny + 1 : ny;
    const int nzf = g.ax[2].wall ? nz + 1 : nz;
    const int t = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
    if (t >= nyf * nzf) return;
    const int j = t / nzf;
    const int k = t - j * nzf;
    const int i = static_cast<int>(blockIdx.y);
    const Pt p{{i, j, k}};
    const T dt = *dt_ptr;
    if (j < ny && k < nz)
        su[i * g.sx[0] + j * g.sy[0] + k] = star<T, NUT, SKEW, 0>(g, p, dt, fx);
    if (k < nz)
        sv[i * g.sx[1] + j * g.sy[1] + k] = star<T, NUT, SKEW, 1>(g, p, dt, fx);
    if (j < ny)
        sw[i * g.sx[2] + j * g.sy[2] + k] = star<T, NUT, SKEW, 2>(g, p, dt, fx);
}

template <typename T, bool NUT, bool SKEW>
void launch_kernel(const Grid<T>& g, const T* dt, T* su, T* sv, T* sw, T fx,
                   cudaStream_t stream) {
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    const int nzf = g.ax[2].wall ? g.ax[2].n + 1 : g.ax[2].n;
    const dim3 grid(cfdnn::blocks_for(static_cast<long long>(nyf) * nzf),
                    static_cast<unsigned>(g.ax[0].n));
    predictor_general_kernel<T, NUT, SKEW><<<grid, cfdnn::kBlock, 0, stream>>>(
        g, dt, su, sv, sw, fx);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* nut, void* su, void* sv, void* sw,
           const void* const* metrics, const double* tang, int nx, int ny,
           int nz, int wall_y, int wall_z, double nu, double fx, int skew,
           void* stream) {
    const int nyf = wall_y ? ny + 1 : ny, nzf = wall_z ? nz + 1 : nz;
    // nx is the launch grid's y extent; offsets are 32-bit
    if (nx > 65535 || static_cast<long long>(nx) * nyf * nzf > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, wall_z, nu);
    const T* d = static_cast<const T*>(dt);
    T* o[3] = {static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nut) {
        if (skew) launch_kernel<T, true, true>(g, d, o[0], o[1], o[2], T(fx), s);
        else launch_kernel<T, true, false>(g, d, o[0], o[1], o[2], T(fx), s);
    } else {
        if (skew) launch_kernel<T, false, true>(g, d, o[0], o[1], o[2], T(fx), s);
        else launch_kernel<T, false, false>(g, d, o[0], o[1], o[2], T(fx), s);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_predictor_general_f32(
        const void* u, const void* v, const void* w, const void* dt,
        const void* nut, void* su, void* sv, void* sw,
        const void* const* metrics, const double* tang, int nx, int ny,
        int nz, int wall_y, int wall_z, double nu, double fx, int skew,
        void* stream) {
    return launch<float>(u, v, w, dt, nut, su, sv, sw, metrics, tang, nx, ny,
                         nz, wall_y, wall_z, nu, fx, skew, stream);
}

extern "C" int cfdnn_predictor_general_f64(
        const void* u, const void* v, const void* w, const void* dt,
        const void* nut, void* su, void* sv, void* sw,
        const void* const* metrics, const double* tang, int nx, int ny,
        int nz, int wall_y, int wall_z, double nu, double fx, int skew,
        void* stream) {
    return launch<double>(u, v, w, dt, nut, su, sv, sw, metrics, tang, nx, ny,
                          nz, wall_y, wall_z, nu, fx, skew, stream);
}
